"""Training: the loss, the train step and its state (``loop.py``)."""
