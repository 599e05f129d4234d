"""The browser UI (`server.py`, `app.html`)."""

from .server import CarverApp, serve

__all__ = ["CarverApp", "serve"]
