"""Training: the synthetic corpus, the four losses, an optimizer written
to match the JAX package's optax chain, checkpoints, and the demo and
retrain trainers."""
