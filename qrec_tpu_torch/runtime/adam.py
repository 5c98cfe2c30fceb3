"""The port's Adam: one arithmetic on a CUDA device for every loop, plain
``torch.optim.Adam``'s, and capturable into a CUDA graph.

``torch.optim.Adam(foreach=True)``, its default on a CUDA device, forms
step t's scalars on the host in f64, ``s_t = (lr / (1 - b1**t)) * -1`` and
``c_t = (1 - b2**t) ** 0.5``, and hands them to its foreach kernels, which
cast them to f32: a CUDA graph would replay step 1's scalars forever. Its
capturable form computes them on the device in f32 and divides in another
order, so a run's bits would depend on whether its loop was captured.
:class:`Adam` keeps the plain form's bits and reads the step on the
device: the moment updates are the plain form's foreach calls, call for
call; the scalars of every step come from a device table that
:func:`adam_scalars` fills on the host with the plain form's Python
expressions; the update is ``ops/kernels.adam_update``
(``csrc/adam.cu``), one launch a tensor, which indexes the table by the
tensor's device step count and rounds each operation as the foreach path
does. On the CPU the step is ``torch.optim.Adam``'s own, unchanged.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels as K

# rows beyond which a pair of betas is refused: the table would not end
MAX_TABLE_ROWS = 1 << 22


@functools.lru_cache(maxsize=None)
def adam_scalars(lr: float, beta1: float, beta2: float) -> np.ndarray:
    """(rows, 2) f32: row t-1 holds step t's ``(s_t, c_t)`` as
    ``torch.optim.Adam``'s foreach path forms them (f64 Python arithmetic on
    the step as a float, then f32), for t = 1 up to the first step where
    both bias corrections ``1 - b**t`` are exactly 1 in f64: from there on
    every step's scalars equal that row's, so the table covers every step
    (a step past the last row reads the last). Raises past
    ``MAX_TABLE_ROWS`` rows (a beta too close to 1)."""
    rows = []
    t = 1
    while True:
        bias_correction1 = 1 - beta1 ** float(t)
        bias_correction2 = 1 - beta2 ** float(t)
        rows.append(((lr / bias_correction1) * -1, bias_correction2 ** 0.5))
        if bias_correction1 == 1.0 and bias_correction2 == 1.0:
            return np.asarray(rows, dtype=np.float32)
        t += 1
        if t > MAX_TABLE_ROWS:
            raise ValueError(f"Adam betas ({beta1}, {beta2}): the bias corrections do not reach "
                             f"1 within {MAX_TABLE_ROWS} steps")


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` at optax.adam's defaults (b1 0.9, b2 0.999, eps
    1e-8). On CUDA parameters (or with ``device_scalars`` True, which tests
    use on CPU tensors) its step is the device form of the module's
    docstring: plain foreach Adam's bits, with device step counts
    (``state["step"]``, f32, on the parameter's device) that a CUDA graph
    replays; ``exp_avg`` and ``exp_avg_sq`` as in ``torch.optim.Adam``, so a
    state dict saves and loads as one does. A parameter without a gradient
    is skipped and keeps its step count, as ``torch.optim.Adam`` does.
    Weight decay, amsgrad and maximize are refused there."""

    def __init__(self, params, lr: float, *, device_scalars: Optional[bool] = None):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.device_scalars = device_scalars
        self._tables: Dict[Tuple, torch.Tensor] = {}

    def _device_form(self) -> bool:
        if self.device_scalars is not None:
            return self.device_scalars
        return any(p.is_cuda for g in self.param_groups for p in g["params"])

    def _state(self, p: torch.Tensor, device_form: bool) -> dict:
        """``p``'s state, made as a first step makes it (a zero f32 step
        count, on ``p``'s device in the device form, and zero moments); a
        loaded step count is moved to ``p``'s device."""
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32,
                                        device=p.device if device_form else "cpu")
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        elif device_form and state["step"].device != p.device:
            state["step"] = state["step"].to(device=p.device, dtype=torch.float32)
        return state

    def _table(self, group: dict, device: torch.device) -> torch.Tensor:
        beta1, beta2 = group["betas"]
        key = (float(group["lr"]), float(beta1), float(beta2), device)
        if key not in self._tables:
            # a copy: the cached array is every optimizer's
            self._tables[key] = torch.tensor(adam_scalars(*key[:3]), device=device)
        return self._tables[key]

    def prepare(self) -> None:
        """The state and the scalar table made now, before a first step: a
        CUDA graph's capture (and the warm-up before it, where a host copy
        is refused) must not make them, and a chunk's snapshot needs the
        state's tensors."""
        device_form = self._device_form()
        for group in self.param_groups:
            for p in group["params"]:
                self._state(p, device_form)
            if device_form and group["params"]:
                self._table(group, group["params"][0].device)

    def step(self, closure=None):
        if not self._device_form():
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with torch.no_grad():
            for group in self.param_groups:
                self._device_step(group)
        return loss

    def _device_step(self, group: dict) -> None:
        if group["weight_decay"] or group["amsgrad"] or group["maximize"]:
            raise ValueError("the device form of Adam takes no weight decay, amsgrad or maximize")
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        states = [self._state(p, True) for p in params]
        grads = [p.grad for p in params]
        exp_avgs = [s["exp_avg"] for s in states]
        exp_avg_sqs = [s["exp_avg_sq"] for s in states]
        steps = [s["step"] for s in states]
        beta1, beta2 = group["betas"]
        # the moment updates of _multi_tensor_adam, call for call
        torch._foreach_add_(steps, 1)
        torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
        torch._foreach_mul_(exp_avg_sqs, beta2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
        table = self._table(group, params[0].device)
        for p, m, v, t in zip(params, exp_avgs, exp_avg_sqs, steps):
            K.adam_update(p, m, v, t, table, group["eps"])
