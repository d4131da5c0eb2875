"""The port's public functions never land on the CPU unless asked: with no
device they use CUDA, or raise where there is none."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import init_decode_state, init_params
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
