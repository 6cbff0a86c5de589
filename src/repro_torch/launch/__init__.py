"""Serving engine and CLI."""
