"""Model stack of the port: the Llama decoder, conversion from the JAX
parameter pytree, and generation."""
