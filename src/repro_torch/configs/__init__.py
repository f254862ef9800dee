"""--arch registry and the configs of the ported architectures."""
