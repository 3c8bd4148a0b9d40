"""The plain reference: PyTorch operations in float32 (TF32 off), one
forward per configuration and the pre-processing, computed from the
frames and weights the benchmark made. It imports nothing of the program
under test."""
