"""Peaks and the work that the models need, counted from shapes.

The peaks are NVIDIA's published figures for one H100 SXM (data sheet,
dense, without sparsity, at 700 W): 3.35 TB/s of HBM3; 989 TFLOP/s on
bf16 tensor cores; 495 TFLOP/s on TF32 tensor cores. A share of a
roofline divides the least time the work could take, the larger of its
bytes over the memory rate and its operations over the fastest rate that
keeps the configuration's precision, by the time the trace gives it: the
propagation's bf16 operands at 989, the float32 products (InfoNCE,
scores) at 495 (no float32-exact implementation runs faster than TF32's
rate). The MFUs hold the model's operations against 989.

Work is what the model needs, whatever implements it: each input byte
read once, each output byte written once, and the arithmetic of the
product, never the work of one kernel's layout.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12


class Work(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def scaled(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)

    def least_s(self, peak_flops: float) -> float:
        return max(self.flops / peak_flops, self.bytes / HBM_BYTES_PER_S)


NONE = Work(0.0, 0.0)


def propagation(users: int, items: int, edges: int, d: int) -> Work:
    """One product of the normalised joint adjacency ``[[0, S], [S^T, 0]]``
    (S = D_u^-1/2 R D_i^-1/2, R binary with ``edges`` nonzeros) with an
    (U + I, d) input. Both halves come from R, so its structure is read
    once: an int32 column index a nonzero and an int32 row pointer a user;
    its values are the two degree scales (float32, one a node), which give
    every entry exactly. The input at its operands' precision (bf16), the
    output in float32. Each nonzero takes part in both halves: 2 x 2 x
    edges x d operations."""
    n = users + items
    return Work(4.0 * edges * d, 4.0 * edges + 4.0 * (users + 1) + 4.0 * n + 2.0 * n * d
                + 4.0 * n * d)


def infonce(rows: float, d: int) -> Work:
    """InfoNCE over ``rows`` aligned pairs of float32 views: 2 rows^2 d
    operations forward, 6 rows^2 d backward; both views read once, both
    gradients written once."""
    return Work(8.0 * rows * rows * d, 4.0 * 4.0 * rows * d)


def topk(users: int, items: int, d: int, k: int) -> Work:
    """The masked top-k of ``users`` test users over the catalogue:
    2 users x items x d operations; the user rows and the item table read
    once, the rated bitmask read once, the lists (int32 ids, float32
    scores) written once."""
    return Work(2.0 * users * items * d,
                4.0 * users * d + 4.0 * items * d + 4.0 * users * -(-items // 32)
                + 8.0 * users * k)


def bpr(rows: int, d: int) -> Work:
    """BPR and its L2 on ``rows`` (user, positive, negative) rows: two dot
    products and three squared norms a row forward (10 d operations), twice
    that backward; three float32 rows read and three gradients written."""
    return Work(30.0 * rows * d, 24.0 * rows * d)


def _apps(shapes: dict, width: int, count: float) -> Work:
    return propagation(shapes["users"], shapes["items"], shapes["edges"], width).scaled(count)


def step_propagation(shapes: dict) -> Work:
    """A training step's products, forward and backward: LightGCN's layers
    at d; SimGCL's first at d and the rest at 3d (its main and perturbed
    encoders in one product)."""
    d, layers = shapes["d"], shapes["layers"]
    if shapes["model"] == "SimGCL":
        return (_apps(shapes, d, 1) + _apps(shapes, 3 * d, layers - 1)).scaled(2)
    return _apps(shapes, d, 2 * layers)


def evaluation(shapes: dict) -> Work:
    """One ranking of every test user: the main encoder's products at d,
    then the top-k."""
    return (_apps(shapes, shapes["d"], shapes["layers"])
            + topk(shapes["test_users"], shapes["items"], shapes["d"], shapes["top_n"]))


def epoch_propagation(shapes: dict) -> Work:
    """An epoch's products: every step's, and the per-epoch evaluation's
    where the model evaluates every epoch."""
    work = step_propagation(shapes).scaled(shapes["steps"])
    if shapes["evaluates"]:
        work = work + _apps(shapes, shapes["d"], shapes["layers"])
    return work


def epoch_infonce(shapes: dict) -> Work:
    """An epoch's InfoNCE: the distinct users and the distinct items of
    every step (SimGCL)."""
    if shapes["model"] != "SimGCL":
        return NONE
    d = shapes["d"]
    return (infonce(shapes["unique_users"], d) + infonce(shapes["unique_items"], d)).scaled(
        shapes["steps"])


def epoch_model(shapes: dict) -> Work:
    """The model's work in one epoch: propagation, BPR, InfoNCE and the
    per-epoch evaluation."""
    work = (epoch_propagation(shapes) + epoch_infonce(shapes)
            + bpr(shapes["pairs"], shapes["d"]))
    if shapes["evaluates"]:
        work = work + topk(shapes["test_users"], shapes["items"], shapes["d"], shapes["top_n"])
    return work
