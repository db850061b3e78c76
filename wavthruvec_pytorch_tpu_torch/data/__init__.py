"""Host-side data for training: the attention prior and the batcher."""
