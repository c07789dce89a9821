"""Roofline: the cost walker over traced aten graphs and the three-term
analysis with the H100's figures."""
