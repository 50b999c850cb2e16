"""Run-time configuration: meshes, parallelism, precision, train/serve knobs.

A copy of the JAX package's ``config/run.py`` (pure dataclasses).  One
difference: ``PrecisionConfig.fp8_gemm`` names the port's two FP8 GEMMs,
``"kernel"`` (the hand-written CUDA kernel, the default) and ``"plain"``
(its plain PyTorch version), or a callable with K4's signature (a check
hands its GEMM to the train step so); the JAX package's ``"ref"`` lets XLA lower the
product, which has no counterpart here, and its ``"pallas"`` corresponds to
``"kernel"``.  ``MeshConfig`` describes the TPU pod's production mesh;
the port's sharded training runs ``ParallelConfig``'s ``fsdp`` and
``tensor_parallel`` over a ``(data, model)`` mesh of ``torch.distributed``
ranks (``repro_torch.train.step``), and raises for
``sequence_parallel``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class MeshConfig:
    """The production mesh from the assignment.

    single pod : (data=16, model=16)          = 256 chips
    multi pod  : (pod=2, data=16, model=16)   = 512 chips
    """

    multi_pod: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Axes the batch is sharded over (DP/FSDP axes)."""
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def model_axis(self) -> str:
        return "model"


@dataclass(frozen=True)
class ParallelConfig:
    """How logical tensor axes map onto the mesh (the JAX package's
    ``parallel/sharding.py``; the port executes ``fsdp`` and
    ``tensor_parallel`` over its ranks, ``repro_torch.train.step``)."""

    # ZeRO-3/FSDP: shard params + optimizer state over the data axes.
    fsdp: bool = True
    # Tensor parallelism over the "model" axis (heads / FFN hidden / experts).
    tensor_parallel: bool = True
    # Shard the residual-stream sequence dim over "model" between blocks
    # (sequence parallelism; needed for the 32k/500k cells).
    sequence_parallel: bool = False
    # Gradient accumulation microbatches inside one train_step.
    num_microbatches: int = 1
    # Activation checkpointing policy for each block:
    #   "none" | "full" (nothing saveable) | "dots" (dots saveable)
    remat: str = "full"
    # Gradient all-reduce compression: "none" | "bf16" | "int8" (the JAX
    # package's parallel/collectives.py, in the train step). Applied to the
    # cross-pod gradient sync.
    grad_compression: str = "none"
    # Apply Adam one layer-slice at a time (bounds fp32 update temps on
    # 100B+ stacked params).  The port keeps one tensor per layer already,
    # so this has no effect there.
    optimizer_layer_scan: bool = False


@dataclass(frozen=True)
class PrecisionConfig:
    param_dtype: str = "float32"  # storage dtype of the master weights
    compute_dtype: str = "bfloat16"
    # Optimizer moments; "bfloat16" halves optimizer memory (arctic-480b).
    optimizer_dtype: str = "float32"
    logits_dtype: str = "float32"

    # --- FP8 quantized training (repro_torch.fp8) ---
    # Route FFN + attention-projection GEMMs through FP8 with delayed
    # scaling; logits/norms/softmax stay on the mixed-precision path above.
    fp8: bool = False
    fp8_dtype: str = "e4m3"  # forward operand dtype; gradients always use e5m2
    fp8_amax_history: int = 16  # delayed-scaling amax window (steps)
    fp8_margin: float = 0.0  # scale headroom: scale = fp8_max / (2^margin * amax)
    fp8_gemm: str | Callable = "kernel"  # "kernel" (CUDA K4) | "plain" (its PyTorch version) | a GEMM


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    z_loss: float = 1e-4  # PaLM-style logit regularizer; also stabilizes fp32 softmax


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 128
    max_seq_len: int = 32_768
    # Paged KV cache block size (tokens per block) for the serving engine.
    page_size: int = 256
    temperature: float = 0.0
    eos_token: int = 1


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assignment's four shapes, verbatim.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    """Everything the launcher needs for one run."""

    arch: str
    mesh: MeshConfig = MeshConfig()
    parallel: ParallelConfig = ParallelConfig()
    precision: PrecisionConfig = PrecisionConfig()
    train: TrainConfig = TrainConfig()
    serve: ServeConfig = ServeConfig()
