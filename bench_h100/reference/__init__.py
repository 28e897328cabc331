"""Plain PyTorch references that decide `correct`: they import torch and
nothing of the program, and work from the arrays the harness builds."""
