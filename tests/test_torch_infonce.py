"""The InfoNCE kernels of the PyTorch port (K3 forward, K4 backward) and
the loss built on them, against the JAX package: the plain versions
against ``_infonce_fwd_call`` / ``_infonce_bwd_call`` in interpret mode, and
the loss value and both gradients against the fused ``infonce_loss`` (in
interpret mode, through ``infonce_dispatch``) and the plain
``masked_infonce``. The CUDA kernels themselves are held against their
plain versions in ``test_torch_kernels_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrec_tpu.ops import losses as jlosses
from qrec_tpu.ops import pallas_kernels as P
from qrec_tpu_torch.ops import kernels as K
from qrec_tpu_torch.ops.losses import InfoNCELoss, _l2n, infonce_dispatch, masked_infonce

TEMP = 0.2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _views(b, d, masked=(), zero_row=None, seed=0):
    """Two (b, d) f32 views, a (b,) mask with 0 at ``masked``, and an all-zero
    row ``zero_row`` in the first view."""
    rng = np.random.RandomState(seed)
    v1 = rng.randn(b, d).astype(np.float32)
    v2 = (v1 + 0.5 * rng.randn(b, d)).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[list(masked)] = 0.0
    if zero_row is not None:
        v1[zero_row] = 0.0
    return v1, v2, mask


def _normalized(v):
    return np.array(P._l2n(jnp.asarray(v)))


# B <= 256 or a multiple of it: the Pallas kernel's row tiling
KERNEL_CASES = [
    pytest.param(1, 8, (), None, id="B1"),
    pytest.param(64, 16, (), None, id="B64"),
    pytest.param(200, 16, (3, 17, 199), 5, id="B200-masked-zero-row"),
    pytest.param(512, 8, tuple(range(0, 512, 7)), 11, id="B512-masked-zero-row"),
]


@pytest.mark.parametrize("b,d,masked,zero_row", KERNEL_CASES)
def test_fwd_plain_matches_pallas_interpret(b, d, masked, zero_row):
    v1, v2, mask = _views(b, d, masked, zero_row)
    n1, n2 = _normalized(v1), _normalized(v2)
    want = float(P._infonce_fwd_call(
        jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(mask)[None, :], TEMP, True
    ))
    m = torch.from_numpy(mask)
    loss, lse = K.infonce_fwd(torch.from_numpy(n1), torch.from_numpy(n2), m, m, TEMP)
    assert loss.shape == () and lse.shape == (b,)
    # f32 sums of b terms in another order
    np.testing.assert_allclose(float(loss), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,d,masked,zero_row", KERNEL_CASES)
def test_bwd_plain_matches_pallas_interpret(b, d, masked, zero_row):
    v1, v2, mask = _views(b, d, masked, zero_row, seed=1)
    n1, n2 = _normalized(v1), _normalized(v2)
    jd1, jd2 = P._infonce_bwd_call(
        jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(mask)[None, :], TEMP, True
    )
    t1, t2, m = torch.from_numpy(n1), torch.from_numpy(n2), torch.from_numpy(mask)
    _, lse = K.infonce_fwd(t1, t2, m, m, TEMP)
    d1, d2 = K.infonce_bwd(t1, t2, m, m, lse, TEMP)
    # softmax from the saved lse instead of max-and-sum: f32 rounding only
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-4, atol=1e-5)


def test_row_offset_matches_pallas_interpret():
    """A block of rows of a larger batch, as one device of the multi-GPU
    path holds it: its positives sit ``row_offset`` columns to the right."""
    b, d, local, off = 128, 16, 64, 64
    v1, v2, mask = _views(b, d, masked=(70, 100), zero_row=90, seed=2)
    n1, n2 = _normalized(v1), _normalized(v2)
    rows = slice(off, off + local)
    args = (
        jnp.asarray([[off]], jnp.int32), jnp.asarray(n1[rows]), jnp.asarray(n2),
        jnp.asarray(mask)[None, :], jnp.asarray(mask[rows])[None, :], TEMP, True,
    )
    want = float(P._infonce_fwd_pallas(*args))
    jd1, jd2 = P._infonce_bwd_pallas(*args)
    t1, t2 = torch.from_numpy(n1[rows].copy()), torch.from_numpy(n2)
    cm, rm = torch.from_numpy(mask), torch.from_numpy(mask[rows].copy())
    loss, lse = K.infonce_fwd(t1, t2, cm, rm, TEMP, row_offset=off)
    d1, d2 = K.infonce_bwd(t1, t2, cm, rm, lse, TEMP, row_offset=off)
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-4, atol=1e-5)


def test_fully_masked_batch_gives_zero():
    v1, v2, _ = _views(20, 8)
    m = torch.zeros(20)
    loss, lse = K.infonce_fwd(_l2n(torch.from_numpy(v1)), _l2n(torch.from_numpy(v2)), m, m, TEMP)
    assert float(loss) == 0.0 and torch.isfinite(lse).all()


LOSS_CASES = [
    pytest.param(1, 16, (), None, id="B1"),
    pytest.param(64, 16, (), None, id="B64"),
    pytest.param(300, 16, (0, 42, 299), 7, id="B300-masked-zero-row"),
    pytest.param(300, 5, tuple(range(1, 300, 3)), 298, id="B300-d5-many-masked"),
]


@pytest.mark.parametrize("b,d,masked,zero_row", LOSS_CASES)
def test_infonce_value_and_grads_match_jax(b, d, masked, zero_row):
    v1, v2, mask = _views(b, d, masked, zero_row, seed=3)
    j1, j2, jm = jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(mask)

    def fused(a, c):
        return jlosses.infonce_dispatch(a, c, jm, TEMP, "pallas", True)

    def plain(a, c):
        return jlosses.masked_infonce(a, c, jm, TEMP)

    want, (wg1, wg2) = jax.value_and_grad(fused, argnums=(0, 1))(j1, j2)
    want_plain, (pg1, pg2) = jax.value_and_grad(plain, argnums=(0, 1))(j1, j2)

    t1 = torch.from_numpy(v1).requires_grad_(True)
    t2 = torch.from_numpy(v2).requires_grad_(True)
    loss = infonce_dispatch(t1, t2, torch.from_numpy(mask), TEMP)
    loss.backward()
    assert torch.isfinite(t1.grad).all() and torch.isfinite(t2.grad).all()
    # the tolerance of tests/test_pallas_kernels.py for the fused loss
    for ref, g1, g2 in ((want, wg1, wg2), (want_plain, pg1, pg2)):
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g1), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(t2.grad.numpy(), np.asarray(g2), rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("b,d,masked,zero_row", LOSS_CASES[1:3])
def test_plain_masked_infonce_matches_jax_and_the_kernel_loss(b, d, masked, zero_row):
    v1, v2, mask = _views(b, d, masked, zero_row, seed=4)
    jm = jnp.asarray(mask)
    want, (wg1, wg2) = jax.value_and_grad(
        lambda a, c: jlosses.masked_infonce(a, c, jm, TEMP), argnums=(0, 1)
    )(jnp.asarray(v1), jnp.asarray(v2))
    grads = []
    for fn in (masked_infonce, InfoNCELoss.apply):
        t1 = torch.from_numpy(v1).requires_grad_(True)
        t2 = torch.from_numpy(v2).requires_grad_(True)
        loss = fn(t1, t2, torch.from_numpy(mask), TEMP)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5, atol=1e-5)
        grads.append((t1.grad, t2.grad))
    np.testing.assert_allclose(grads[0][0].numpy(), np.asarray(wg1), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(grads[0][1].numpy(), np.asarray(wg2), rtol=1e-4, atol=2e-5)
    # autograd of the plain function and the explicit backward agree
    (a1, a2), (b1, b2) = grads
    torch.testing.assert_close(a1, b1, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(a2, b2, rtol=1e-4, atol=2e-5)


def test_infonce_wrappers_reject_bad_inputs():
    v1, v2, m = torch.zeros((4, 3)), torch.zeros((5, 3)), torch.ones(5)
    rm = torch.ones(4)
    with pytest.raises(TypeError):
        K.infonce_fwd(v1.double(), v2, m, rm, TEMP)
    with pytest.raises(ValueError):
        K.infonce_fwd(v1, v2, m[:4], rm, TEMP)  # cmask must cover B
    with pytest.raises(ValueError):
        K.infonce_fwd(v1, v2[:, :2], m, rm, TEMP)
    with pytest.raises(ValueError):
        K.infonce_fwd(v1.t(), v2, m, rm, TEMP)  # not contiguous
    with pytest.raises(ValueError):
        K.infonce_fwd(torch.zeros((0, 3)), v2, m, torch.ones(0), TEMP)
    with pytest.raises(ValueError):
        K.infonce_fwd(torch.zeros((4, 257)), torch.zeros((5, 257)), m, rm, TEMP)
    with pytest.raises(ValueError):
        K.infonce_bwd(v1, v2, m, rm, torch.zeros(5), TEMP)  # lse is per row of v1
    # a device that is neither cpu nor cuda never reaches the plain version
    with pytest.raises(ValueError):
        K.infonce_fwd(v1.to("meta"), v2.to("meta"), m.to("meta"), rm.to("meta"), TEMP)


def test_infonce_cpu_calls_do_not_count_as_launches():
    before = K.launch_counts()
    t1 = torch.randn(6, 4, requires_grad=True)
    infonce_dispatch(t1, torch.randn(6, 4), torch.ones(6), TEMP).backward()
    assert K.launch_counts() == before
    assert {"infonce_fwd", "infonce_bwd"} <= set(before)
