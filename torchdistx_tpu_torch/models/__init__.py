"""Model stack of the port: the Llama, GPT-2 and MoE decoders, conversion
from the JAX parameter pytrees and Hugging Face checkpoints, and
generation."""
