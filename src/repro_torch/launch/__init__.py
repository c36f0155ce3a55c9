"""Step factories of the port: prefill and serve at tp = 1 on one card."""
