"""Step factories, train state and the training loop of the port, at
tp = 1 on one card: prefill and serve, and training with replicas stacked
on the card."""
