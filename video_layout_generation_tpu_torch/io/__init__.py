"""Weight loading: the flax parameter tree -> the port's state dict."""
