"""The Carver lifecycle object."""
