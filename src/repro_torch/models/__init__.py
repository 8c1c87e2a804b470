"""Model layers and the paged-KV transformer (attention-block families)."""
