"""Matrix fingerprint sample (reference: clients/samples/key.cpp,
LocalMatrix::Key): a structural+numeric hash to identify matrices across
runs. Port of clients/samples/key.py: the keys are the JAX package's."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.utils.key import matrix_key

A = rt.laplacian_2d(30)
B = rt.laplacian_2d(30)
C = rt.laplacian_2d(31)
ka, kb, kc = matrix_key(A), matrix_key(B), matrix_key(C)
print("key(A) =", ka)
assert ka == kb, "identical matrices must share a key"
assert ka != kc, "different matrices must differ"
print("key invariants hold")
