"""Training: the optimizer state and the train steps (port of
``etts/train``)."""
