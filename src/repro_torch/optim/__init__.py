"""Optimizers and learning-rate schedules (``optim.optimizers``)."""
