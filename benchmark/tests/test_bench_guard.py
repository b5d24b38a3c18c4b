"""The import guard compares top-level module names whole."""
from harness import guard


def test_port_name_is_not_the_jax_package():
    assert guard.forbidden_loaded(["vqengine_tpu_torch",
                                   "vqengine_tpu_torch.ops.raster"]) == []


def test_forbidden_names_found():
    assert guard.forbidden_loaded(["vqengine_tpu.ops", "jax.numpy", "jaxlib",
                                   "flax.linen", "numpy"]) == [
        "flax", "jax", "jaxlib", "vqengine_tpu"]


def test_prefixes_are_not_names():
    assert guard.forbidden_loaded(["jaxtyping", "flaxen", "vqengine_tpux"]) == []
