"""Training: the LAMB optimizer, the Text2Vec step and its loop."""
