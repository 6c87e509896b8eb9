"""Serving: the continuous batcher and the OpenAI-compatible HTTP server."""
