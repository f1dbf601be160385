"""Model zoo (this slice: GPT-2, the serving subset)."""
