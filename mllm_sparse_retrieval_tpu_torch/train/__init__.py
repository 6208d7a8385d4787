"""Contrastive LoRA training on one device (the JAX package's ``train``)."""
