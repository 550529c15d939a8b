"""Plain PyTorch reference models of the benchmark's configurations.

They follow the published descriptions, in float32 with TF32 off, and
import nothing of the program under test: the comparison that decides a
run's ``correct`` holds the program's outputs against them.
"""
