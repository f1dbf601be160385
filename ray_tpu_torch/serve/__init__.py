"""Serving (this slice: the continuous-batching LLM engine)."""
