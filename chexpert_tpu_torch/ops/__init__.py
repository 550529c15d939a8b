"""Attention math (plain torch) and the fused kernel's wrapper."""
