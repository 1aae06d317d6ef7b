"""The benchmark of ``pointcloududa_torch`` on the card: whole training
iterations through ``UDATrainer.train_epoch``. ``perfbench/README.md`` says
how to run a cell and how to add one."""
