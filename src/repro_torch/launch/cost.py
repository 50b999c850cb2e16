"""Op-level cost model: FLOPs, modelled HBM bytes and peak live memory of one call.

The counterpart of the JAX package's ``launch/jaxpr_cost.py``.  Where that
walks the closed jaxpr of the function a dry run lowers, this runs the
function itself, on tensors of the meta device (shapes and dtypes, no
memory), under a ``TorchDispatchMode`` that sees every aten op the call
dispatches, and counts each by the JAX model's conventions:

* matrix products exactly, 2·M·N·K·batch (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``_scaled_mm``, the vector products and convolutions); a
  convolution's backward as the two products it computes;
* elementwise ops at 1 FLOP an element of their output, 4 for the
  transcendentals (``exp``, ``log``, ``tanh``, ``rsqrt``, ...); reductions
  at 1 FLOP an element of their input;
* bytes only where the JAX model charges them, the materializing ops: the
  operands and results of products, gathers, scatters, index ops,
  concatenations, sorts and scans, and the inputs of reductions.
  Elementwise ops, views, transposes, copies and casts count as fused
  (``_FREE``) and move nothing.  An fp8 tensor widened by a cast keeps its
  one-byte width for the product that reads it, as K4 reads the fp8
  operands the plain GEMM widens first.

A fused aten op that stands for several JAX primitives is counted as those
primitives (``_COMPOSITES``): ``_softmax`` as a max- and a sum-reduction
over its input plus the subtraction, exponential and division,
``logsumexp`` likewise, ``var`` as its two reductions, ``mean`` as a sum
and a division, ``silu`` as a logistic and a product, and the tanh
``gelu`` as the chain ``jax.nn.gelu`` lowers to.  So both models count the
same work.

There is no scan in the port: the layer loop is Python, and each layer's
ops are seen as they run, so nothing is multiplied by a trip count and no
scan carry is charged (the JAX model adds the carry's read and write per
iteration, about 1% of a dense forward's bytes).  Backward ops and the
recompute under ``torch.utils.checkpoint`` are counted as they run, as
``jaxpr_cost`` counts remat.

The same mode follows every storage the call allocates and frees
(``weakref.finalize`` on the storage, so views and in-place ops are not
counted twice): ``peak_bytes`` is the most bytes live at once, the
arguments' storages included, the counterpart of the compiled
``memory_analysis()`` the JAX dry run reads.

Numbers are those of the call traced: the global step on one card, or one
rank's step on a mesh (``launch.dryrun``).  A collective (an op of the
``c10d`` namespace, such as ``allreduce_``) costs no FLOPs and no HBM
bytes here: its operand bytes are counted where the port issues it
(``parallel.collectives``); ``collective_ops`` counts the ops seen.
"""

from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _size(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensors(obj) -> list[torch.Tensor]:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _name(func) -> str:
    return func.overloadpacket.__name__


# --- matrix products ---------------------------------------------------------


def _mm_flops(a, b) -> int:  # (..., M, K) @ (..., K, N), batch dims leading
    batch = math.prod(a.shape[:-2]) if a.dim() > 2 else 1
    return 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _conv_flops(x, w, out) -> int:
    # 2 x output elements x (input channels per group x kernel taps)
    return 2 * out.numel() * math.prod(w.shape[1:])


PRODUCTS = {
    "mm": lambda a: _mm_flops(a[0], a[1]),
    "bmm": lambda a: _mm_flops(a[0], a[1]),
    "addmm": lambda a: _mm_flops(a[1], a[2]),
    "baddbmm": lambda a: _mm_flops(a[1], a[2]),
    "addbmm": lambda a: _mm_flops(a[1], a[2]),
    "_scaled_mm": lambda a: _mm_flops(a[0], a[1]),
    "mv": lambda a: 2 * a[0].numel(),
    "addmv": lambda a: 2 * a[1].numel(),
    "dot": lambda a: 2 * a[0].numel(),
    "vdot": lambda a: 2 * a[0].numel(),
}
# the matrix operands of each product (a bias or a scale is no operand of the
# JAX model's dot_general)
_OPERANDS = {"addmm": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2), "addmv": (1, 2), "_scaled_mm": (0, 1)}
_CONVS = {"convolution", "_convolution", "convolution_backward"}

# --- reductions and composites ----------------------------------------------

# reductions: 1 FLOP and its bytes per input element, ``passes`` times over
# the input, plus elementwise FLOPs per input element (``elem_in``) and per
# output element (``elem_out``), as the JAX primitives of the same function
#   name: (passes, elem_in, elem_out)
_COMPOSITES = {
    "sum": (1, 0, 0),
    "nansum": (1, 0, 0),
    "prod": (1, 0, 0),
    "amax": (1, 0, 0),
    "amin": (1, 0, 0),
    "max": (1, 0, 0),
    "min": (1, 0, 0),
    "argmax": (1, 0, 0),
    "argmin": (1, 0, 0),
    "any": (1, 0, 0),
    "all": (1, 0, 0),
    "aminmax": (2, 0, 0),
    "mean": (1, 0, 1),  # reduce_sum, div
    "var": (2, 2, 2),  # mean; sub, square; reduce_sum, div
    "std": (2, 2, 6),  # var, then sqrt
    "var_mean": (2, 2, 2),
    "std_mean": (2, 2, 6),
    "linalg_vector_norm": (1, 1, 4),  # square, reduce_sum, sqrt
    "norm": (1, 1, 4),
    "logsumexp": (2, 5, 5),  # reduce_max, sub, exp, reduce_sum, log, add
    "_softmax": (2, 6, 0),  # reduce_max, sub, exp, reduce_sum, div
    "_log_softmax": (2, 6, 4),  # reduce_max, sub, exp, reduce_sum, log, sub
    "_softmax_backward_data": (1, 3, 0),  # y * (g - sum(y * g)): mul, reduce_sum, sub, mul
    "_log_softmax_backward_data": (1, 6, 0),  # g - exp(y) * sum(g)
    "native_layer_norm": (2, 4, 6),  # mean, var, then (x - mu) * rsqrt(var + eps)
    "native_layer_norm_backward": (2, 8, 0),
    "cumsum": (1, 0, 0),
    "cumprod": (1, 0, 0),
    "logcumsumexp": (1, 8, 0),
}
# reductions that the JAX model charges as materializing (operands and
# results both): the scans and sorts
_SCANS = {"cumsum", "cumprod", "logcumsumexp", "sort", "topk", "argsort", "kthvalue", "median", "mode"}

# --- materializing ops: operands and results both ---------------------------

_MATERIALIZING = {
    "index", "_unsafe_index", "index_select", "gather", "embedding", "embedding_dense_backward", "take",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "_index_put_impl", "index_add", "index_copy",
    "index_fill", "masked_scatter", "masked_select", "nonzero", "cat", "stack", "slice_scatter",
    "select_scatter", "diagonal_scatter", "sort", "topk", "argsort", "kthvalue", "median", "mode",
    "_embedding_bag", "bincount", "unique_dim", "_unique2", "searchsorted",
}

# --- free: views, layout, casts, creation, logical ---------------------------

_FREE = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand", "expand_as", "squeeze",
    "unsqueeze", "slice", "select", "alias", "detach", "clone", "contiguous", "_to_copy", "to", "copy", "copy_",
    "as_strided", "split", "split_with_sizes", "unbind", "chunk", "narrow", "diagonal", "flip", "roll",
    "repeat", "repeat_interleave", "empty", "empty_like", "empty_strided", "zeros", "ones", "full", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_empty", "new_ones", "new_full", "new_empty_strided", "arange",
    "lift_fresh", "lift_fresh_copy", "scalar_tensor", "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "logical_and", "logical_or", "logical_not", "logical_xor", "_local_scalar_dense", "fill", "zero", "set",
    "unfold", "view_as_real", "view_as_complex", "_reshape_alias", "resize_", "resize", "tril", "triu",
    "promote_types", "result_type", "item", "_has_compatible_shallow_copy_type", "is_same_size", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "dim", "stride", "size", "numel", "record_stream",
    "_foreach_copy", "detach_", "requires_grad_", "set_", "lift", "_assert_async", "_assert_tensor_metadata",
    "sym_constrain_range_for_size", "_functional_assert_async",
}
# views and copies an fp8 width travels through to the product that reads it
_PASS_WIDTH = {"view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand", "squeeze", "unsqueeze",
               "slice", "select", "alias", "detach", "clone", "contiguous", "as_strided", "_reshape_alias"}

# --- elementwise: 1 FLOP an output element, or these per element -------------

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "erf", "erfc", "erfinv", "sigmoid",
    "rsqrt", "sqrt", "sin", "cos", "tan", "atan", "atan2", "asin", "acos", "sinh", "cosh", "softplus",
    "logit", "lgamma", "digamma",
}
_ELEMENTWISE = {
    "silu": 5,  # logistic, mul
    "silu_backward": 8,  # the JAX transpose of x * logistic(x)
    "gelu": 11,  # jax.nn.gelu(approximate=True): x**3, mul, add, mul, tanh, add, mul, mul
    "gelu_backward": 18,
    "sigmoid_backward": 2,
    "tanh_backward": 2,
    "softplus_backward": 6,
    "mish": 13,
    "elu": 5,
    "threshold_backward": 1,
}


def _pow_flops(args) -> int:
    """``x ** 2`` is JAX's ``integer_pow`` (1 FLOP); any other power is
    ``pow``, a transcendental."""
    exp = args[1] if len(args) > 1 else None
    if isinstance(exp, (int, float)) and float(exp).is_integer():
        return 1
    return 4


class CostMode(TorchDispatchMode):
    """Counts FLOPs and modelled bytes of every op dispatched inside it,
    and the live and peak bytes of the storages it sees.  ``track``
    registers tensors made before the mode (the arguments)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: set[int] = set()
        self._width = WeakIdKeyDictionary()  # fp8 tensors widened by a cast: their 1-byte width
        self.collective_ops: dict[str, int] = {}  # the c10d ops seen, by name

    # storages -------------------------------------------------------------
    def track(self, *trees) -> None:
        for t in _tensors(trees):
            self._register(t)

    def _register(self, t: torch.Tensor) -> None:
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):  # sparse or otherwise storage-less
            return
        key = s._cdata
        if key in self._seen:
            return
        nbytes = s.nbytes()
        self._seen.add(key)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key, nbytes)

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live -= nbytes

    # counting ---------------------------------------------------------------
    def _nbytes(self, t: torch.Tensor) -> int:
        return t.numel() * self._width.get(t, t.element_size())

    def _charge(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes

    def _count(self, func, args, kwargs, out) -> None:
        name = _name(func)
        base = name[:-1] if name.endswith("_") else name  # in place: as its out-of-place op
        if base in ("max", "min") and func._overloadname == "other":
            base = "maximum"  # elementwise
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if base in PRODUCTS:
            ops = _OPERANDS.get(base, (0, 1))
            nbytes = sum(self._nbytes(args[i]) for i in ops) + sum(self._nbytes(t) for t in outs)
            self._charge(PRODUCTS[base](args), nbytes)
        elif base in _CONVS:
            x, w = args[0], args[1]
            if base == "convolution_backward":  # grad_out, input, weight: dx and dw, each a forward's work
                x, w = args[1], args[2]
                flops = 2 * _conv_flops(x, w, args[0])
            else:
                flops = _conv_flops(x, w, outs[0])
            self._charge(flops, sum(self._nbytes(t) for t in ins + outs))
        elif base in _COMPOSITES:
            passes, elem_in, elem_out = _COMPOSITES[base]
            x = ins[0] if base not in ("_softmax_backward_data", "_log_softmax_backward_data") else ins[1]
            n = _size(x)
            n_out = _size(outs[0]) if outs else 0
            nbytes = passes * self._nbytes(x)
            if base in _SCANS:
                nbytes = sum(self._nbytes(t) for t in ins + outs)
            self._charge(passes * n + elem_in * n + elem_out * n_out, nbytes)
        elif base in _MATERIALIZING:
            flops = sum(_size(t) for t in ins) if base in _SCANS else 0
            self._charge(flops, sum(self._nbytes(t) for t in ins + outs))
        elif base in _FREE:
            pass
        elif base == "slice_backward":  # JAX: the transpose of a slice is a pad, elementwise
            self._charge(_size(outs[0]), 0)
        else:
            n = sum(_size(t) for t in outs)
            if base in _ELEMENTWISE:
                per = _ELEMENTWISE[base]
            elif base in _TRANSCENDENTAL:
                per = 4
            elif base == "pow":
                per = _pow_flops(args)
            else:
                per = 1
            self._charge(per * n, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":  # a collective: its bytes are counted where it is issued
            self.collective_ops[_name(func)] = self.collective_ops.get(_name(func), 0) + 1
        else:
            self._count(func, args, kwargs, out)
        name = _name(func)
        outs = _tensors(out)
        if outs and args and isinstance(args[0], torch.Tensor):
            src = args[0]
            if name in ("_to_copy", "to") and src.dtype in FP8_DTYPES and outs[0].dtype not in FP8_DTYPES:
                self._width[outs[0]] = 1
            elif name in _PASS_WIDTH and src in self._width:
                for t in outs:
                    self._width[t] = self._width[src]
        for t in outs:
            self._register(t)
        return out


def storage_bytes(*trees) -> int:
    """Bytes of the distinct storages behind the tensors of ``trees``."""
    seen = {}
    for t in _tensors(trees):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def estimate_cost(fn, *meta_args, **meta_kwargs) -> dict:
    """Global FLOPs, modelled HBM bytes and peak live bytes of
    ``fn(*meta_args)``, run once on meta tensors under ``CostMode``:
    ``{"flops", "hbm_bytes", "peak_bytes"}``."""
    mode = CostMode()
    mode.track(meta_args, meta_kwargs)
    with mode:
        out = fn(*meta_args, **meta_kwargs)
    del out
    return {"flops": float(mode.flops), "hbm_bytes": float(mode.hbm_bytes), "peak_bytes": int(mode.peak),
            "collective_ops": dict(mode.collective_ops)}
