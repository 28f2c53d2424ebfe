"""Training substrate of the port: the AdamW optimizer, atomic verified
checkpoints in the JAX package's layout, and the fault tools."""
