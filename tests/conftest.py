import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic
# is exercised without a card. Tests that need the GPU carry the `gpu`
# marker and decide inside the `gpu_device` fixture whether one is present.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

# CI checks out the (public) reference repo elsewhere and points this at it
REFERENCE_ROOT = os.environ.get("SILO_REFERENCE_ROOT", "/root/reference")


def reference_available() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_ROOT, "testBaseData"))


@pytest.fixture(scope="session")
def example_dataset_db():
    """The exampleDataset corpus built through the full ingest pipeline."""
    if not reference_available():
        pytest.skip("reference test data not available")
    from lapis_silo_tpu.config.database_config import get_validated_config
    from lapis_silo_tpu.preprocessing.preprocessing_config import read_preprocessing_config
    from lapis_silo_tpu.preprocessing.preprocessor import Preprocessor

    base = os.path.join(REFERENCE_ROOT, "testBaseData/exampleDataset/")
    dbconf = get_validated_config(base + "database_config.yaml")
    pcfg = read_preprocessing_config(base + "preprocessing_config.yaml")
    pcfg.input_directory = base
    return Preprocessor(pcfg, dbconf).preprocess()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX runs on anything
    else."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX runs on {device.platform})")
    return device


@pytest.fixture
def vm_kernel_reference():
    """Route the VM through the GPU path's wrapper (ops/vm_kernel.py) with
    the kernel's jnp reference standing in for the CUDA call, so the CPU
    exercises the wrapper's chunking, padding and sharding."""
    from lapis_silo_tpu.ops import vm_kernel

    with vm_kernel.reference_route():
        yield vm_kernel
