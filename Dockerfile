# unires-tpu runtime image (parity with the reference's Dockerfile, which
# builds nitorch's CUDA backend — here the accelerator stack is JAX with its
# CUDA plugin, so the image is pure Python plus the pinned JAX line).
#
# Build:  docker build -t unires-tpu:0.2 .
# Run  :  docker run --rm --gpus all -v $PWD:/data unires-tpu:0.2 \
#             /data/t1.nii --vx 1.0
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/* \
    && pip install --no-cache-dir "jax[cuda12]==0.9.*" numpy scipy matplotlib

WORKDIR /opt/unires-tpu
COPY pyproject.toml README.md ./
COPY unires_tpu ./unires_tpu
RUN pip install --no-cache-dir .

# persistent XLA compilation cache across container restarts
ENV JAX_COMPILATION_CACHE_DIR=/var/cache/unires_tpu_jax
VOLUME /var/cache/unires_tpu_jax

ENTRYPOINT ["unires"]
