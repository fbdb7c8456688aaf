"""Training substrate: AdamW and the tier-0 head's distillation (the rest
of the reference's training stack is ported in a later slice)."""
