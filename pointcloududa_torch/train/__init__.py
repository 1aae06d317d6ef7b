"""Train state, optimisers, the 5-phase UDA train step and the device
preprocess."""
