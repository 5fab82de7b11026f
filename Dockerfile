# lapis-silo-tpu server image (parity with reference Dockerfile:36-49:
# two-mode entrypoint, default configs baked in, /info healthcheck).
# This image runs the engine on JAX's CPU backend; on a GPU host install
# jax[cuda12] instead (the filter VM then builds native/silo_vm.cu with
# nvcc on first use).
FROM python:3.12-slim AS server

WORKDIR /app

RUN apt-get update \
    && apt-get install -y --no-install-recommends curl jq zstd libzstd-dev g++ make \
    && rm -rf /var/lib/apt/lists/*

RUN pip install --no-cache-dir "jax[cpu]" numpy

COPY pyproject.toml ./
COPY lapis_silo_tpu ./lapis_silo_tpu
COPY native ./native
# pre-build the native ingest + HTTP libraries (the loader would otherwise
# build them lazily on first use); no -march=native — the image must run
# on any host
RUN make -C native CXXFLAGS="-O3 -fPIC -std=c++17 -Wall"
COPY docker/docker_default_preprocessing_config.yaml ./default_preprocessing_config.yaml
COPY docker/docker_runtime_config.yaml ./runtime_config.yaml

# /info, extract sequenceCount, assert non-zero (reference Dockerfile:45)
HEALTHCHECK --start-period=20s CMD curl --fail --silent localhost:8081/info | jq .sequenceCount | xargs test 0 -ne || exit 1

EXPOSE 8081

ENTRYPOINT ["python", "-m", "lapis_silo_tpu.cli"]
