"""Batches for the train and eval steps."""
