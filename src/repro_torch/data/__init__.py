"""Data substrate: world simulator, SCOPE-60K/250 synthesis, tokenizer."""
