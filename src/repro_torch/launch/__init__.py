"""Entry points: the training launcher."""
