"""Entry points: the training and serving launchers."""
