"""Volume-level inference and evaluation (Dice/HD/ASD per structure), and
the predictor with its ``torch.export`` artifact."""
