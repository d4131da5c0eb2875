"""The port's public functions never land on the CPU unless asked: with no
device they use CUDA, or raise where there is none. The ``meta`` device
(the linter's and the dry run's) is taken only when named."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.device import on_cuda, resolve_device
from repro_torch.kernels import expert_quant_matmul
from repro_torch.models.model import init_decode_state, init_params, \
    quantize_model
from repro_torch.params import from_reference, tensor_from_numpy

TREE = {"w": np.ones((2, 3), np.float32),
        "q": {"packed": np.zeros((4, 8), np.uint8),
              "scales": np.ones((1, 4), np.float32), "bits": 4,
              "group_size": 16, "k": 16}}


def _default_or_raise(fn):
    """fn() on the default device: CUDA where there is a card, else a
    RuntimeError."""
    if torch.cuda.is_available():
        return fn()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()
    return None


def test_from_reference_defaults_to_cuda():
    got = _default_or_raise(lambda: from_reference(TREE))
    if got is not None:
        assert got["w"].is_cuda and got["q"].packed.is_cuda
    cpu = from_reference(TREE, "cpu")
    assert cpu["w"].device.type == "cpu" and cpu["q"].bits == 4
    got = _default_or_raise(lambda: tensor_from_numpy(TREE["w"]))
    assert got is None or got.is_cuda


def test_init_decode_state_defaults_to_cuda():
    cfg = get_config("olmoe_1b_7b").reduced()
    got = _default_or_raise(lambda: init_decode_state(cfg, 1, 8))
    if got is not None:
        assert got["layers"].k.is_cuda
    cpu = init_decode_state(cfg, 1, 8, "cpu")
    assert cpu["layers"].k.shape[:2] == (cfg.num_layers, 1)
    assert cpu["layers"].k.device.type == "cpu"


def test_init_params_takes_the_generators_device():
    cfg = get_config("olmoe_1b_7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert params["embed"].device.type == "cpu"


def test_meta_is_taken_only_by_name():
    assert resolve_device("meta").type == "meta"
    assert not on_cuda(torch.empty(2, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    cfg = get_config("olmoe_1b_7b").reduced()
    caches = init_decode_state(cfg, 2, 8, "meta")
    assert caches["layers"].k.is_meta
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="meta")
    assert params["embed"].is_meta
    # a kernel entry point on meta: its output's shape and dtype, no data
    mp = quantize_model(params, cfg)["layers"]["moe"]["w_gate"].index(0)
    x = torch.empty((cfg.num_experts, 3, cfg.d_model), device="meta")
    y = expert_quant_matmul(x, mp, torch.ones(cfg.num_experts,
                                              dtype=torch.int32,
                                              device="meta"),
                            out_dtype=torch.float32)
    assert y.is_meta and y.shape == (cfg.num_experts, 3, cfg.expert_d_ff)
