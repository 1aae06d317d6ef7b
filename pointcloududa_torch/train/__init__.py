"""Train state, optimisers and the 5-phase UDA train step."""
