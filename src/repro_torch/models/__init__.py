"""Decoder layers, attention, the transformer and the model facade."""
