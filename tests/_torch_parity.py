"""Shared helpers for the parity tests of ``repro_torch`` against ``repro``.

Inputs are made with numpy from a seed and handed to both packages; results
are compared through numpy with exact equality (everything is int32/bool).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.types import GraphState as TorchGraphState


def to_np(x) -> np.ndarray:
    """A numpy array from a JAX array, a torch tensor or a numpy array
    (bfloat16 tensors come out as float32, which holds them exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def state_columns(state) -> dict:
    """The eight columns of a GraphState of either package, as numpy."""
    return {f: to_np(getattr(state, f)) for f in TorchGraphState._fields}


def assert_states_equal(a, b, ctx="") -> None:
    ca, cb = state_columns(a), state_columns(b)
    for f in TorchGraphState._fields:
        np.testing.assert_array_equal(ca[f], cb[f], err_msg=f"{ctx} column {f}")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at test time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    """One torch thread for the test: the suite runs in several worker
    processes, and eight threads in each made small train steps 50 times
    slower than one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
