"""Input specs on the meta device + per-cell run knobs for the dry run.

The counterpart of the JAX package's ``launch/specs.py``.
``train_input_specs(model_cfg, shape)`` and its siblings return meta
tensors (``torch.empty(shape, dtype=..., device="meta")``: shapes and
dtypes, no memory) with the JAX specs' shapes and dtypes for every model
input: tokens and labels for a train step, frames for the audio frontend,
image tokens for the vlm family, the request batch for decode (whose cache
``launch.dryrun`` builds from ``models.cache``'s layout).

``CellKnobs``, ``TRAIN_KNOBS``, ``PREFILL_Q_CHUNK``, ``run_config_for``,
``cell_status`` and ``enumerate_cells`` are copies of the JAX package's:
the knobs of each (arch x shape) cell (microbatches, remat, query chunking,
precision), chosen there for the TPU pod's memory.  The port runs them on
one card; the sharding knobs (``fsdp``, ``tensor_parallel``,
``sequence_parallel``) describe the pod and change nothing on one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.config import (
    SHAPES,
    MeshConfig,
    ModelConfig,
    ParallelConfig,
    PrecisionConfig,
    RunConfig,
    ShapeConfig,
    TrainConfig,
)


def meta(shape, dtype) -> torch.Tensor:
    """A stand-in input: ``shape`` and ``dtype`` on the meta device."""
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    specs: dict = {}
    if cfg.family == "audio":
        specs["frames"] = meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        specs["tokens"] = meta((B, S), torch.int32)
    specs["labels"] = meta((B, S), torch.int32)
    if cfg.family == "vlm":
        specs["vision_tokens"] = meta((B, cfg.vision.num_image_tokens, cfg.d_model), torch.bfloat16)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    specs = train_input_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B = shape.global_batch
    return {"token": meta((B, 1), torch.int32), "pos": meta((B,), torch.int32)}


# ---------------------------------------------------------------------------
# per-cell knobs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CellKnobs:
    num_microbatches: int = 1
    sequence_parallel: bool = True
    q_chunk: int = 1024
    remat: str = "full"
    # precision overrides (None = RunConfig defaults)
    param_dtype: str | None = None
    optimizer_dtype: str | None = None
    grad_compression: str = "none"
    optimizer_layer_scan: bool = False
    # FP8 quantized training (train cells only; see repro_torch.fp8)
    fp8: bool = False


# The JAX package's baseline knobs (activation bytes per TPU chip <= ~4 GB).
TRAIN_KNOBS: dict[str, CellKnobs] = {
    "rwkv6-7b": CellKnobs(num_microbatches=2),
    "olmo-1b": CellKnobs(num_microbatches=1),
    "mistral-nemo-12b": CellKnobs(num_microbatches=2),
    "stablelm-12b": CellKnobs(num_microbatches=2),
    "gemma-7b": CellKnobs(num_microbatches=4),
    "hubert-xlarge": CellKnobs(num_microbatches=2),
    "arctic-480b": CellKnobs(num_microbatches=8, param_dtype="bfloat16", optimizer_dtype="bfloat16"),
    "qwen3-moe-235b-a22b": CellKnobs(num_microbatches=8, optimizer_dtype="bfloat16"),
    "hymba-1.5b": CellKnobs(num_microbatches=2),
    "llama-3.2-vision-90b": CellKnobs(num_microbatches=8, optimizer_dtype="bfloat16"),
    "bert-large": CellKnobs(num_microbatches=1),
}

PREFILL_Q_CHUNK = 512


def run_config_for(arch: str, shape: ShapeConfig, mesh: MeshConfig = MeshConfig(),
                   knobs: CellKnobs | None = None) -> RunConfig:
    knobs = knobs or (TRAIN_KNOBS.get(arch, CellKnobs()) if shape.kind == "train" else CellKnobs())
    par = ParallelConfig(
        # decode: weights are model-sharded and stationary on the pod
        fsdp=shape.kind != "decode",
        tensor_parallel=True,
        sequence_parallel=knobs.sequence_parallel and shape.kind != "decode",
        num_microbatches=knobs.num_microbatches if shape.kind == "train" else 1,
        remat=knobs.remat if shape.kind == "train" else "none",
        grad_compression=knobs.grad_compression,
        optimizer_layer_scan=knobs.optimizer_layer_scan,
    )
    prec = PrecisionConfig(
        param_dtype=(knobs.param_dtype or ("bfloat16" if shape.kind != "train" else "float32")),
        optimizer_dtype=knobs.optimizer_dtype or "float32",
        fp8=knobs.fp8 and shape.kind == "train",
    )
    tr = TrainConfig(global_batch=shape.global_batch, seq_len=shape.seq_len)
    return RunConfig(arch=arch, mesh=mesh, parallel=par, precision=prec, train=tr)


# ---------------------------------------------------------------------------
# cell enumeration with the assignment's skip rules
# ---------------------------------------------------------------------------


def cell_status(cfg: ModelConfig, shape_name: str) -> str:
    """'run' | the reason the cell is skipped."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode" and cfg.is_encoder_only:
        return "skip: encoder-only (no autoregressive decode step)"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return "skip: pure full-attention arch (no sub-quadratic mechanism)"
    return "run"


def enumerate_cells(archs: list[str]) -> list[tuple[str, str, str]]:
    """[(arch, shape_name, status)] over the full 40-cell grid."""
    from repro_torch.configs import get_config

    cells = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            cells.append((arch, shape_name, cell_status(cfg, shape_name)))
    return cells
