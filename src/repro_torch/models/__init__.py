"""Dense transformer, paged KV cache, parameters."""
