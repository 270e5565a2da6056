"""The port's fused_quorum against the JAX package's (Pallas kernel in
interpret mode, and the XLA path), and the CUDA kernel against its plain
version on a card.  Exact equality throughout: int32 and bool outputs.

On a machine with a card (and no JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_quorum.py
"""

import numpy as np
import pytest
import torch

from tpuraft_torch.ops import quorum_cuda
from tpuraft_torch.ops.quorum_cuda import fused_quorum, fused_quorum_reference

NEG = -(2**30)
NAMES = ("quorum_idx", "elected", "q_ack")


def _random_case(rng, g, p, joint_frac=0.3):
    match = rng.integers(-1, 100, (g, p)).astype(np.int32)
    ack = np.where(rng.random((g, p)) < 0.85,
                   rng.integers(0, 10_000, (g, p)), NEG).astype(np.int32)
    granted = rng.random((g, p)) < 0.5
    vm = rng.random((g, p)) < 0.6
    ovm = (rng.random((g, p)) < 0.4) & (rng.random((g, 1)) < joint_frac)
    return match, granted, ack, vm, ovm


def _degenerate_case():
    """No voters (inactive slot rows), single voters, a NEG-ack voter."""
    g, p = 8, 4
    match = np.arange(g * p, dtype=np.int32).reshape(g, p)
    ack = match * 2
    ack[5, 0] = NEG
    granted = np.ones((g, p), bool)
    vm = np.zeros((g, p), bool)
    vm[4:, 0] = True
    ovm = np.zeros((g, p), bool)
    return match, granted, ack, vm, ovm


def _compare(case, impl):
    # JAX is imported here, not at the top: the card's machine runs this
    # file's gpu test without the JAX package installed
    import jax.numpy as jnp

    from tpuraft.ops.quorum_pallas import fused_quorum as jax_fused_quorum

    want = jax_fused_quorum(*map(jnp.asarray, case), impl=impl)
    got = fused_quorum(*map(torch.from_numpy, case))
    for name, w, t in zip(NAMES, want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w),
                                      err_msg=f"{name} ({impl})")


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("g,p", [(1, 4), (7, 8), (130, 8), (700, 16)])
def test_matches_jax(g, p, impl):
    _compare(_random_case(np.random.default_rng(g * 31 + p), g, p), impl)


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_degenerate_rows_match_jax(impl):
    _compare(_degenerate_case(), impl)


def _bad_inputs(kind):
    case = [torch.from_numpy(a) for a in
            _random_case(np.random.default_rng(1), 6, 8)]
    if kind == "p_over_32":
        case = [torch.from_numpy(a) for a in
                _random_case(np.random.default_rng(1), 6, 33)]
    elif kind == "int64_match":
        case[0] = case[0].to(torch.int64)
    elif kind == "int_mask":
        case[3] = case[3].to(torch.int32)
    elif kind == "shape":
        case[2] = case[2][:5]
    elif kind == "strided":
        case[4] = torch.from_numpy(
            np.ascontiguousarray(case[4].numpy().T)).T
    elif kind == "one_dim":
        case = [c[0] for c in case]
    return case


@pytest.mark.parametrize("kind,exc", [
    ("p_over_32", ValueError), ("int64_match", TypeError),
    ("int_mask", TypeError), ("shape", ValueError), ("strided", ValueError),
    ("one_dim", ValueError)])
def test_wrapper_rejects(kind, exc):
    with pytest.raises(exc):
        fused_quorum(*_bad_inputs(kind))


def test_non_cpu_tensor_never_takes_plain_version():
    """Only CPU tensors take the plain version; any other device goes to
    the kernel or raises (here: the meta device, which has no kernel)."""
    case = [t.to("meta") for t in _bad_inputs("none")]
    before = quorum_cuda.LAUNCHES
    with pytest.raises(ValueError, match="unsupported device"):
        fused_quorum(*case)
    assert quorum_cuda.LAUNCHES == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(quorum_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(quorum_cuda, "_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        quorum_cuda.build()


@pytest.mark.gpu
def test_kernel_matches_plain_on_cuda():
    """Every P the kernel takes, ragged G, empty / single-voter / joint /
    NEG rows: kernel == plain version, both on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(7)
    before = quorum_cuda.LAUNCHES
    for p in range(1, quorum_cuda.MAX_PEERS + 1):
        g = int(rng.integers(1, 3000))
        case = list(_random_case(rng, g, p))
        case[3][rng.random(g) < 0.1] = False
        case[0][rng.random((g, p)) < 0.05] = NEG - 1
        dev = [torch.from_numpy(a).cuda() for a in case]
        got = fused_quorum(*dev)
        want = fused_quorum_reference(*dev)
        torch.cuda.synchronize()
        for name, t, w in zip(NAMES, got, want):
            assert t.is_cuda
            assert torch.equal(t, w), f"{name} P={p} G={g}"
    assert quorum_cuda.LAUNCHES == before + quorum_cuda.MAX_PEERS
