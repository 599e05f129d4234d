"""Configuration and the carve state shared with the JAX package."""
