"""Training loop, optimizers, gradient compression (counterpart of
``repro.training``)."""
