"""Plain PyTorch references of the cells' models, written for the
benchmark from the configurations' equations: no kernel, cache or
batching trick, and nothing of the program imported."""
