"""Input assembly and the autoregressive rollout."""
