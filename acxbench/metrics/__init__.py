"""One file per per-layer metric, named as the metric: its unit, layer,
the end-to-end metric it should move and its source, and ``read(art)``
over the traced run's artifacts (``drivers/*.py``: ``artifacts()``),
which returns None where the run holds nothing for it to read."""

SERVE_LOOP = "serve loop: models/serving.py"
MODEL_STEP = "model step: models/decoding.py, models/transformer.py, models/llama.py"
KERNELS = "kernels: K1 (ops/attention.py), K2 (ops/flash_decode.py)"
DEVICE = "device"
TOKEN_DATA = "token data: data.py"
TRAIN_STEP = "train step: train.py, parallel/pipeline.py, autograd, AdamW"
