"""Autoregressive decode engine (slot-based continuous batching), PyTorch.

Counterpart of ``skypilot_tpu/models/decode.py``: the same slots, paged
KV pool, admission paths, speculative verify step and metrics, in eager
PyTorch on one device.

  - **paged KV** (``SKYTPU_KV_BLOCK=64``): one global pool of fixed-size
    blocks ``[L, num_blocks, kvh, block, d]`` addressed through per-slot
    block tables; the host-side allocator and hash-chain prefix cache
    (``models/paged_kv.py``) decide which physical blocks a sequence
    maps, and full prefix blocks are shared across slots.
  - **contiguous KV** (``kv_block=0``): one ``[max_len]`` region per
    slot, ``[L, B, kvh, max_len + 1, d]``; the extra row of each slot is
    a sink for the verify step's dropped writes and is never read.
  - **int8 KV** (``kv_dtype='int8'``, paged only): absmax int8 codes
    plus one f32 scale per row, written through the same addresses and
    dequantised to f32 in the gather.
  - **slots**: a fixed decode batch of B sequences with per-row
    ``lengths``; prompts are padded to a bucket (``prefill_bucket``).
  - **monolithic prefill** (``prefill``, ``admit`` and the batched
    ``admit_many``) runs attention through the hand-written CUDA flash
    kernel on the card (``ops/attention.py``); the decode, verify and
    chunk paths attend over the gathered pool rows in plain tensor code,
    as the JAX engine does with ``einsum``.
  - **models**: the block math is the model's (``model=``): Llama's, or
    a ``MixtralModel``'s, whose MoE routes each dispatch's flattened
    [B, S] rows together (bucket padding and parked slots included), as
    the JAX engine feeds them.
  - sampling (greedy / temperature / top-k) runs on the device from a
    ``torch.Generator`` the caller owns, so a step's only host traffic
    is the sampled token ids.

State is updated IN PLACE: the JAX engine donates its ``DecodeState`` to
every jitted call; here the KV pool and the per-slot bookkeeping tensors
are written where they lie, and every call returns the same state
object. Each step returns FRESH ``sampled``/``out`` tensors, never views
of the state, because the server's emitter thread reads them while later
steps run. All work is enqueued on the current CUDA stream of the
calling thread; the server's scheduler and emitter both use the default
stream, so reads are ordered after the writes that produced them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch import env_vars
from skypilot_tpu_torch.models import paged_kv
from skypilot_tpu_torch.models.llama import LlamaConfig, LlamaModel, Params
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops.layers import precompute_rotary, rms_norm
from skypilot_tpu_torch.utils import metrics as metrics_lib
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

_NEG_INF = -1e30


class StepProfiler:
    """Engine-side metrics: step timing, token mix, dispatch variants.

    Registered on the process default registry so the generation
    server's ``/metrics`` exposes engine series next to scheduler ones.
    The engine holds ``profiler = None`` when metrics are disabled, so
    every instrumentation site is a single ``is not None`` branch.

    The recompile counter counts FIRST-SEEN dispatch variants host-side
    (kind, shape) — prefill buckets, chunk_spans final-bucket variants,
    the step itself — under the JAX engine's metric name, so dashboards
    read both engines alike. Eager PyTorch compiles nothing per variant;
    the count still says which shapes traffic reached.
    """

    def __init__(self):
        self.step_ms = metrics_lib.histogram(
            'skytpu_engine_step_ms',
            'decode step dispatch wall time',
            buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250,
                     1000, 10000, 60000))
        self.steps = metrics_lib.counter(
            'skytpu_engine_steps_total', 'decode steps dispatched')
        self.recompiles = metrics_lib.counter(
            'skytpu_engine_recompiles_total',
            'first-seen jit variants (compile-cache misses)')
        self.prefill_tokens = metrics_lib.counter(
            'skytpu_engine_prefill_tokens_total',
            'prefill tokens dispatched (padded buckets)')
        self.decode_tokens = metrics_lib.counter(
            'skytpu_engine_decode_tokens_total',
            'decode tokens dispatched for active slots')
        self.occupancy = metrics_lib.gauge(
            'skytpu_engine_occupancy_ratio',
            'active slots / batch slots at the last decode step')
        # Host-side gap between consecutive step dispatches: the time
        # the dispatch queue is NOT being fed. With >= 2 steps in
        # flight the device rides out these gaps; the histogram is the
        # signal that says whether it has to. Sub-ms buckets: on local
        # hardware the healthy gap is tens of microseconds.
        self.step_gap_ms = metrics_lib.histogram(
            'skytpu_engine_step_gap_ms',
            'host gap between consecutive decode step dispatches',
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
                     25, 50, 100, 1000))
        self.inflight_steps = metrics_lib.gauge(
            'skytpu_engine_inflight_steps_count',
            'decode steps dispatched but not yet fetched by the emitter')
        # Speculative-decode series. The accept histogram observes
        # tokens EMITTED per verify step (accept + 1: the accepted
        # draft prefix plus the corrected token), so its mean
        # (sum/count) is accepted_tokens_per_step directly — the
        # dashboard's "accept/step" column and the ROADMAP target
        # (> 1.8 on repetitive traffic) read straight off it.
        self.spec_accept = metrics_lib.histogram(
            'skytpu_engine_spec_accept_tokens',
            'tokens emitted per verify step (accepted prefix + 1)',
            buckets=(1, 2, 3, 4, 5, 6, 7, 8, 9, 16))
        self.spec_draft_hits = metrics_lib.counter(
            'skytpu_engine_spec_draft_hits_total',
            'draft tokens accepted by verification')
        self.spec_verify_ms = metrics_lib.histogram(
            'skytpu_engine_spec_verify_ms',
            'verify step dispatch wall time',
            buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250,
                     1000, 10000, 60000))
        # Quantized-KV series. kv_bytes_per_token is what int8 storage
        # halves; the scale histogram is the accuracy canary — scales
        # drifting toward the top buckets mean coarser quantization
        # steps (absmax/127), which is where greedy agreement degrades
        # first. Log-spaced buckets: bf16 activations put typical
        # per-row absmax around 1e-2..1, so the edges bracket that by
        # two decades each way.
        self.kv_bytes_per_token = metrics_lib.gauge(
            'skytpu_engine_kv_bytes_per_token',
            'KV cache bytes stored per token across all layers/heads')
        self.kv_quant_scale = metrics_lib.histogram(
            'skytpu_engine_kv_quant_scale_ratio',
            'per-row absmax quantization scales sampled at scrape time',
            buckets=(1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3,
                     1.0, 3.0, 10.0))
        self._seen_variants: set = set()
        # Roofline attribution state: static (FLOPs, bytes) per compiled
        # step variant (note_roofline, filled at warmup) joined with a
        # measured per-variant dispatch-time EWMA (note_step attributes
        # each step to the variant the preceding note_variant named).
        self._variant_labels: Dict[tuple, str] = {}
        self._variant_costs: Dict[str, Tuple[float, float]] = {}
        self._variant_step_s: Dict[str, float] = {}
        self._current_variant: Optional[str] = None
        # Last-N raw gap samples, per-PROFILER (one profiler per
        # engine): the registry histogram above is process-global, so a
        # same-process A/B (depth-1 vs depth-2 engines in one test or
        # bench run) needs a per-engine distribution to compare.
        self.gap_samples: 'deque[float]' = deque(
            maxlen=self.GAP_SAMPLES_MAX)

    GAP_SAMPLES_MAX = 4096
    # EWMA weight for the per-variant step-time attribution: slow
    # enough to ride out one compile stall, fast enough that the MFU
    # gauge tracks a real regime change within ~10 steps.
    STEP_EWMA_ALPHA = 0.2

    @staticmethod
    def variant_label(kind: str, *shape) -> str:
        """Stable label for one jit variant: ``step:8``,
        ``step_verify:8x4``, ``prefill_chunk_final:64`` — the key the
        roofline gauge family and the cost table share. Shape entries
        may themselves be dim tuples (``admit_many`` passes the whole
        array shape); they flatten into the same ``x``-joined form."""
        dims = []
        for s in shape:
            if isinstance(s, (tuple, list)):
                dims.extend(int(d) for d in s)
            else:
                dims.append(int(s))
        if not dims:
            return kind
        return kind + ':' + 'x'.join(str(d) for d in dims)

    def note_variant(self, kind: str, *shape) -> None:
        key = (kind, *shape)
        label = self._variant_labels.get(key)
        if label is None:
            label = self.variant_label(kind, *shape)
            self._variant_labels[key] = label
            self._seen_variants.add(key)
            self.recompiles.inc()
        self._current_variant = label

    def note_step(self, wall_s: float) -> None:
        self.steps.inc()
        self.step_ms.observe(wall_s * 1e3)
        variant = self._current_variant
        if variant is not None:
            prev = self._variant_step_s.get(variant)
            self._variant_step_s[variant] = (
                wall_s if prev is None
                else prev + self.STEP_EWMA_ALPHA * (wall_s - prev))

    def note_gap(self, gap_s: float) -> None:
        ms = gap_s * 1e3
        self.step_gap_ms.observe(ms)
        self.gap_samples.append(ms)

    def note_inflight(self, depth: int) -> None:
        self.inflight_steps.set(depth)

    def note_occupancy(self, active: int, total: int) -> None:
        self.occupancy.set(active / total if total else 0.0)
        self.decode_tokens.inc(active)

    def note_spec_accept(self, accept: int, k: int) -> None:
        """One slot's verify outcome: ``accept`` of ``k`` draft tokens
        survived, so accept + 1 tokens were emitted this step."""
        self.spec_accept.observe(accept + 1)
        if accept:
            self.spec_draft_hits.inc(accept)

    def note_kv_config(self, kv_dtype: str, bytes_per_token: int) -> None:
        """Engine-construction facts: the storage dtype as a Prometheus
        info gauge (constant 1, dtype label) and the per-token KV
        footprint the dtype implies."""
        metrics_lib.gauge(
            'skytpu_engine_kv_dtype_info',
            'KV cache storage dtype (constant 1; dtype label)',
            labels={'dtype': kv_dtype}).set(1)
        self.kv_bytes_per_token.set(bytes_per_token)

    def note_hbm(self, ledger: Dict[str, float],
                 block_stats: Optional[Dict[str, float]] = None) -> None:
        """Publish the HBM ledger (component -> bytes) as the labeled
        ``skytpu_engine_hbm_bytes`` gauge family, plus the block-pool
        utilization/fragmentation ratios when ``hbm_block_stats()``
        output is passed (scrape-time refresh; registration is
        idempotent, so repeat scrapes just .set())."""
        def comp(component: str, nbytes: float) -> None:
            metrics_lib.gauge(
                'skytpu_engine_hbm_bytes',
                'device-memory accounting by component',
                labels={'component': component}).set(nbytes)

        for component, nbytes in ledger.items():
            comp(component, nbytes)
        if block_stats:
            comp('kv_used', block_stats.get('kv_used_bytes', 0))
            comp('kv_free', block_stats.get('kv_free_bytes', 0))
            metrics_lib.gauge(
                'skytpu_engine_hbm_kv_utilization_ratio',
                'used fraction of the KV block pool').set(
                    block_stats.get('kv_block_utilization', 0.0))
            metrics_lib.gauge(
                'skytpu_engine_hbm_fragmentation_ratio',
                'share of pool bytes in free-but-resident blocks').set(
                    block_stats.get('kv_fragmentation_ratio', 0.0))

    def note_roofline(self,
                      costs: Dict[str, Tuple[float, float]]) -> None:
        """Record the compiled-cost table (variant -> (FLOPs, bytes
        accessed) per dispatch, from ``DecodeEngine.roofline_costs`` at
        warmup) and publish the static halves as labeled gauges. The
        dynamic halves — MFU and arithmetic intensity joined with the
        measured step-time EWMA — refresh at scrape time via
        :meth:`roofline_snapshot` (``note_hbm`` cadence)."""
        self._variant_costs.update(costs)
        for variant, (flops, nbytes) in costs.items():
            metrics_lib.gauge(
                'skytpu_engine_step_flops',
                'FLOPs one dispatch of this jit step variant executes',
                labels={'variant': variant}).set(flops)
            metrics_lib.gauge(
                'skytpu_engine_step_bytes',
                'HBM bytes one dispatch of this jit step variant moves',
                labels={'variant': variant}).set(nbytes)

    def roofline_snapshot(self, peak_flops: float = 0.0
                          ) -> Dict[str, Dict[str, float]]:
        """variant -> {flops, bytes, ai, step_ms, mfu}; refreshes the
        ``skytpu_engine_step_ai_ratio`` / ``_mfu_ratio`` gauges.

        AI = FLOPs / bytes places the variant on the roofline's x-axis
        (below the chip's FLOPs:bandwidth ratio = bandwidth-bound);
        MFU = FLOPs / (step_time * peak) is how much of the machine the
        variant actually uses. ``peak_flops`` <= 0 (SKYTPU_PEAK_TFLOPS
        unset) reports MFU 0 — AI and the static gauges still export.
        """
        out: Dict[str, Dict[str, float]] = {}
        for variant, (flops, nbytes) in sorted(
                self._variant_costs.items()):
            ai = flops / nbytes if nbytes > 0 else 0.0
            step_s = self._variant_step_s.get(variant)
            mfu = 0.0
            if step_s and peak_flops > 0:
                mfu = flops / step_s / peak_flops
            metrics_lib.gauge(
                'skytpu_engine_step_ai_ratio',
                'arithmetic intensity (FLOPs per HBM byte) of this '
                'step variant', labels={'variant': variant}).set(ai)
            metrics_lib.gauge(
                'skytpu_engine_step_mfu_ratio',
                'serving MFU of this step variant: FLOPs / (measured '
                'dispatch EWMA x SKYTPU_PEAK_TFLOPS)',
                labels={'variant': variant}).set(mfu)
            out[variant] = {
                'flops': flops, 'bytes': nbytes, 'ai': ai,
                'step_ms': (step_s or 0.0) * 1e3, 'mfu': mfu,
            }
        return out


def peak_flops() -> float:
    """$SKYTPU_PEAK_TFLOPS in FLOP/s — the MFU denominator. 0.0 when
    unset: the roofline MFU gauges report 0 but AI/FLOPs/bytes still
    export (they need no hardware constant)."""
    return float(env_vars.get('SKYTPU_PEAK_TFLOPS') or 0.0) * 1e12



@dataclasses.dataclass
class DecodeState:
    """Batched decode state: the KV cache + per-slot bookkeeping.

    Paged mode (``kv_block > 0``, the default): k/v are ONE global pool
    of fixed-size blocks [L, num_blocks, kvh, block, d] and
    ``block_tables[b]`` lists the physical block ids holding slot b's
    rows in order. Row ``p`` of slot ``b`` lives at pool row
    ``(block_tables[b, p // block], p % block)``; unassigned table
    entries point at the reserved null block 0, whose rows are never
    read unmasked.

    Contiguous mode (``kv_block = 0``): k/v are [L, B, kvh, M + 1, d]
    (M = max_len, head-major) and ``block_tables`` is an empty [B, 0]
    placeholder. Row M of each slot is a write sink: the verify step
    sends its dropped rows there (the JAX engine drops them with
    ``mode='drop'``); attention reads rows [0, M) only.

    Int8 mode (``kv_dtype='int8'``, paged only): k/v hold int8 codes and
    ``k_scale``/``v_scale`` the f32 absmax scale of each (layer, block,
    kv-head, row), [L, NB, kvh, BS]; a scale is written by the same
    scatter as its row. Otherwise the scale fields are zero-size
    placeholders. Index tensors are int64 (torch's index type).
    """
    k: torch.Tensor             # [L, NB, kvh, BS, d] or [L, B, kvh, M+1, d]
    v: torch.Tensor             # same layout as k
    lengths: torch.Tensor       # [B] int64: tokens in each slot's cache
    last_tokens: torch.Tensor   # [B] int64: next token to feed per slot
    active: torch.Tensor        # [B] bool: slot occupied
    block_tables: torch.Tensor  # [B, max_blocks] int64 (paged), [B, 0]
    k_scale: torch.Tensor       # [L, NB, kvh, BS] f32 (int8), [0] else
    v_scale: torch.Tensor       # same layout as k_scale


KV_DTYPES = ('bf16', 'int8')


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantisation over the trailing head_dim.

    ``x`` [..., d] float -> (int8 codes [..., d], f32 scales [...]).
    Scale = absmax / 127 per row; an all-zero row gets scale 0 and codes
    0, so zero rows round-trip exactly. The arithmetic of the JAX
    function: an f32 division (not a reciprocal product), round half to
    even, clip to +-127, so codes and scales are bit-equal on the same
    f32 input."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`: int8 codes [..., d] x f32
    scales [...] -> f32 rows."""
    return q.float() * scale[..., None]


class DecodeEngine:
    """Prefill / insert / step over a fixed slot batch on one device.

    ``device`` defaults to ``'cuda'``; without a CUDA device the engine
    raises unless the caller passes ``device='cpu'``.
    """

    def __init__(self, config: LlamaConfig, batch_slots: int = 8,
                 max_len: Optional[int] = None,
                 model: Optional[LlamaModel] = None,
                 kv_block: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 spec_tokens: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 device: DeviceLike = None):
        """``kv_block`` ($SKYTPU_KV_BLOCK, default 64; 0 = contiguous
        per-slot KV): rows per KV block; ``kv_blocks`` ($SKYTPU_KV_BLOCKS,
        default batch_slots * ceil(max_len/block) + null block): pool
        size. ``spec_tokens`` ($SKYTPU_SPEC_TOKENS, default 4; 0 = plain
        one-token steps) only gates the CALLER's choice of
        ``step_verify``. ``kv_dtype`` ($SKYTPU_KV_DTYPE, default 'bf16'):
        'int8' stores absmax codes + f32 per-row scales, half the KV
        bytes per token; it requires the paged layout."""
        self.config = config
        self.device = resolve_device(device)
        if model is None:
            # Block math only: the weights arrive as ``params`` per call.
            model = LlamaModel(config, device='meta')
        elif model.device.type != 'meta' and model.device != self.device:
            raise ValueError(f'model lives on {model.device}, engine on '
                             f'{self.device}')
        self.model = model
        self.batch_slots = batch_slots
        self.max_len = max_len or config.max_seq_len
        if kv_block is None:
            kv_block = env_vars.get_int('SKYTPU_KV_BLOCK')
        self.kv_block = max(0, int(kv_block))
        self.paged = self.kv_block > 0
        if kv_dtype is None:
            kv_dtype = env_vars.get('SKYTPU_KV_DTYPE') or 'bf16'
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f'SKYTPU_KV_DTYPE must be one of '
                             f'{KV_DTYPES}, got {kv_dtype!r}')
        if kv_dtype == 'int8' and not self.paged:
            raise ValueError(
                'SKYTPU_KV_DTYPE=int8 requires the paged KV layout '
                '(SKYTPU_KV_BLOCK > 0): the contiguous kv_block=0 path '
                'is the bit-identity equivalence oracle and stays '
                'bf16')
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == 'int8'
        # Slots driven without an explicit table (tests, warmup) get a
        # full-capacity assignment on first touch, cached so the same
        # slot always maps the same ids.
        self._auto_tables: Dict[int, torch.Tensor] = {}
        if self.paged:
            self.max_blocks = -(-self.max_len // self.kv_block)
            # Gathered per-slot view length; >= max_len when max_len is
            # not a block multiple (the overhang is always masked).
            self.m_pad = self.max_blocks * self.kv_block
            if kv_blocks is None:
                kv_blocks = env_vars.get_int('SKYTPU_KV_BLOCKS') or None
            if kv_blocks is None:
                kv_blocks = batch_slots * self.max_blocks + 1
            self.kv_blocks = max(int(kv_blocks), 2)
            self.allocator = paged_kv.BlockAllocator(
                self.kv_blocks, self.kv_block, reserved=1)
        else:
            self.max_blocks = 0
            self.m_pad = self.max_len
            self.kv_blocks = 0
            self.allocator = None
        if spec_tokens is None:
            spec_tokens = env_vars.get_int('SKYTPU_SPEC_TOKENS')
        self.spec_tokens = max(0, int(spec_tokens))
        # Built once per engine (the JAX engine rebuilt these inside
        # every traced function): rotary tables in f32 on the device,
        # and index helpers.
        c = config
        self._cos, self._sin = precompute_rotary(
            c.head_dim, c.max_seq_len, c.rope_theta, device=self.device)
        self._kv_pos = torch.arange(self.m_pad, device=self.device)
        self._kv_heads = torch.arange(c.num_kv_heads, device=self.device)
        self._slot_ids = torch.arange(batch_slots, device=self.device)
        # f32 copy of the lm head, made once per weights (see _head32).
        self._head32_cache: Optional[torch.Tensor] = None
        self._head32_key: Optional[tuple] = None
        # Scalar sampling settings -> cached device [B] tensors (LRU:
        # the settings are client-supplied).
        self._scalar_sampling_cache: 'OrderedDict' = OrderedDict()
        self.profiler = (StepProfiler()
                         if metrics_lib.enabled() else None)
        if self.profiler is not None:
            self.profiler.note_kv_config(self.kv_dtype,
                                         self.kv_bytes_per_token())
        self._last_dispatch_end: Optional[float] = None

    def note_dispatch_break(self) -> None:
        """Caller (the scheduler) is about to wait for work: break the
        step-gap chain so the idle wait is not recorded as a gap."""
        self._last_dispatch_end = None

    # -- state --------------------------------------------------------------
    def init_state(self) -> DecodeState:
        c = self.config
        b = self.batch_slots
        if self.paged:
            shape = (c.num_layers, self.kv_blocks, c.num_kv_heads,
                     self.kv_block, c.head_dim)
        else:
            # + 1: the per-slot write sink of the verify step.
            shape = (c.num_layers, b, c.num_kv_heads, self.max_len + 1,
                     c.head_dim)
        if self.quantized:
            pool_dtype = torch.int8
            scale_shape = shape[:-1]  # one f32 scale per row
        else:
            pool_dtype = c.dtype
            scale_shape = (0,)
        dev = self.device
        return DecodeState(
            k=torch.zeros(shape, dtype=pool_dtype, device=dev),
            v=torch.zeros(shape, dtype=pool_dtype, device=dev),
            lengths=torch.zeros(b, dtype=torch.long, device=dev),
            last_tokens=torch.zeros(b, dtype=torch.long, device=dev),
            active=torch.zeros(b, dtype=torch.bool, device=dev),
            block_tables=torch.zeros((b, self.max_blocks),
                                     dtype=torch.long, device=dev),
            k_scale=torch.zeros(scale_shape, dtype=torch.float32,
                                device=dev),
            v_scale=torch.zeros(scale_shape, dtype=torch.float32,
                                device=dev),
        )

    def kv_bytes_per_token(self) -> int:
        """Device bytes one cached token row costs across all layers (K
        and V, scales included) — the capacity denominator."""
        c = self.config
        if self.quantized:
            per_head = c.head_dim + 4  # int8 codes + one f32 scale
        else:
            per_head = c.head_dim * c.dtype.itemsize
        return 2 * c.num_layers * c.num_kv_heads * per_head

    def hbm_ledger(self, state: DecodeState,
                   params: Optional[Params] = None) -> Dict[str, int]:
        """Device-memory accounting table (component -> bytes), from
        shapes only. Paged: ``kv_code_pool + kv_scale_pool ==
        kv_bytes_per_token() * kv_block * kv_blocks`` for bf16 and int8.
        Contiguous: the code pool includes each slot's sink row (one
        row per slot and layer more than the JAX engine's)."""
        def nbytes(t: torch.Tensor) -> int:
            return t.numel() * t.element_size()

        ledger: Dict[str, int] = {}
        if params is not None:
            ledger['weights'] = (
                sum(nbytes(t) for t in params['layers'].values())
                + sum(nbytes(t) for name, t in params.items()
                      if name != 'layers'))
        ledger['kv_code_pool'] = nbytes(state.k) + nbytes(state.v)
        ledger['kv_scale_pool'] = (nbytes(state.k_scale)
                                   + nbytes(state.v_scale))
        ledger['spec_buffers'] = (
            2 * self.batch_slots * (1 + self.spec_tokens) * 4
            if self.spec_tokens else 0)
        return ledger

    def hbm_block_stats(self) -> Dict[str, float]:
        """Block-pool utilization/fragmentation companion to the ledger
        (paged mode; empty otherwise)."""
        if not self.paged:
            return {}
        stats = self.allocator.stats()
        total = max(1, stats['kv_blocks_total'])
        block_bytes = self.kv_bytes_per_token() * self.kv_block
        return {
            'kv_block_bytes': block_bytes,
            'kv_used_bytes': stats['kv_blocks_used'] * block_bytes,
            'kv_free_bytes': stats['kv_blocks_free'] * block_bytes,
            'kv_block_utilization': stats['kv_block_utilization'],
            'kv_fragmentation_ratio': stats['kv_blocks_free'] / total,
        }

    def observe_kv_scales(self, state: DecodeState, cap: int = 512) -> None:
        """Sample layer 0's nonzero k-scales (at most ``cap``) into the
        quant-scale histogram: the int8 accuracy canary, at scrape time
        only (it copies them to the host)."""
        if not self.quantized or self.profiler is None:
            return
        flat = state.k_scale[0].reshape(-1)
        for s in flat[flat > 0.0][:cap].tolist():
            self.profiler.kv_quant_scale.observe(float(s))

    # -- roofline attribution ------------------------------------------------
    ROOFLINE_KINDS = ('prefill', 'prefill_chunk', 'prefill_chunk_final',
                      'step', 'step_verify')

    def estimate_step_cost(self, kind: str, *shape) -> Tuple[float, float]:
        """Analytic (FLOPs, device bytes) for ONE dispatch of a step
        variant, from config dims only (the JAX engine's formula).

        FLOPs: layer matmuls ``2 * P_layers * T`` (T = padded token rows),
        lm head ``2 * E * V * T_logits``, attention ``4 * L * Hq * d * T
        * M`` over the padded context M. Bytes: the weights once per
        dispatch plus the KV rows gathered and written."""
        c = self.config
        b = self.batch_slots
        if kind == 'step':
            t, t_logits, seqs, m = b, b, b, self.m_pad
        elif kind == 'step_verify':
            k = int(shape[1]) if len(shape) > 1 else self.spec_tokens
            t, t_logits, seqs, m = b * (1 + k), b * (1 + k), b, self.m_pad
        elif kind in ('prefill_chunk', 'prefill_chunk_final'):
            t, t_logits, seqs, m = int(shape[0]), 1, 1, self.m_pad
        elif kind == 'prefill':
            t, t_logits, seqs, m = int(shape[0]), 1, 1, int(shape[0])
        else:
            raise ValueError(f'no cost model for variant kind {kind!r}')
        qkv = c.embed_dim * c.head_dim * (c.num_heads
                                          + 2 * c.num_kv_heads)
        proj = c.num_heads * c.head_dim * c.embed_dim
        mlp = 3 * c.embed_dim * c.mlp_dim
        p_layers = c.num_layers * (qkv + proj + mlp)
        flops = (2.0 * p_layers * t
                 + 2.0 * c.embed_dim * c.vocab_size * t_logits
                 + 4.0 * c.num_layers * c.num_heads * c.head_dim * t * m)
        param_bytes = c.num_params * c.dtype.itemsize
        kv_bytes = self.kv_bytes_per_token() * (seqs * m + t)
        return flops, float(param_bytes + kv_bytes)

    def roofline_costs(self, params: Optional[Params] = None,
                       state: Optional[DecodeState] = None
                       ) -> Dict[str, Tuple[float, float]]:
        """(FLOPs, bytes) per step variant seen so far (the profiler's
        first-seen set), keyed by :meth:`StepProfiler.variant_label`.
        Analytic only: XLA's compiled cost model has no PyTorch twin."""
        b = self.batch_slots
        variants: List[tuple] = []
        if self.profiler is not None:
            variants = [key for key in self.profiler._seen_variants
                        if key[0] in self.ROOFLINE_KINDS]
        if not variants:
            variants = [('step', b)]
            if self.spec_tokens > 0:
                variants.append(('step_verify', b, self.spec_tokens))
        return {StepProfiler.variant_label(key[0], *key[1:]):
                self.estimate_step_cost(key[0], *key[1:])
                for key in sorted(variants, key=str)}

    # -- paged-KV host-side helpers -----------------------------------------
    def _table_arg(self, slot: Optional[int], table_row) -> torch.Tensor:
        """Device table row for an admission: the caller's explicit
        assignment (scheduler), the slot's cached auto assignment, or an
        empty placeholder (contiguous)."""
        if not self.paged:
            return torch.zeros(0, dtype=torch.long, device=self.device)
        if table_row is not None:
            row = torch.as_tensor(table_row, dtype=torch.long,
                                  device=self.device)
            if tuple(row.shape) != (self.max_blocks,):
                raise ValueError(f'table row must be [{self.max_blocks}]'
                                 f', got {tuple(row.shape)}')
            return row
        return self._auto_table(slot)

    def _auto_table(self, slot: int) -> torch.Tensor:
        """Full-capacity block assignment for ``slot``, allocated once
        and reused (the same admission order on two engines maps
        identical physical ids)."""
        row = self._auto_tables.get(slot)
        if row is None:
            ids = self.allocator.alloc(self.max_blocks)
            if ids is None:
                raise RuntimeError(
                    f'KV pool exhausted auto-assigning slot {slot}: '
                    f'{self.allocator.available()} of '
                    f'{self.allocator.capacity} blocks free')
            row = torch.tensor(ids, dtype=torch.long, device=self.device)
            self._auto_tables[slot] = row
        return row

    def free_auto_tables(self) -> None:
        """Release every auto-assigned slot's blocks back to the pool."""
        for row in self._auto_tables.values():
            self.allocator.deref([int(b) for b in row.tolist()])
        self._auto_tables.clear()

    def reset_kv(self) -> None:
        """Forget all host-side block state (crash recovery, paired with
        a fresh ``init_state``)."""
        if self.paged:
            self.allocator.reset()
            self._auto_tables.clear()

    @staticmethod
    def _gather_slot(pool_layer: torch.Tensor, table_row: torch.Tensor,
                     scale_layer: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """[NB, kvh, BS, d] pool gathered through [nb] -> [kvh, M, d].
        With ``scale_layer`` ([NB, kvh, BS] f32, int8 mode) the rows
        dequantise to f32 in the gather."""
        g = pool_layer[table_row]                      # [nb, kvh, BS, d]
        if scale_layer is not None:
            g = dequantize_kv_rows(g, scale_layer[table_row])
        g = g.permute(1, 0, 2, 3)                      # [kvh, nb, BS, d]
        return g.reshape(g.shape[0], -1, g.shape[3])

    @staticmethod
    def _gather_batch(pool_layer: torch.Tensor, tables: torch.Tensor,
                      scale_layer: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """[NB, kvh, BS, d] pool gathered through [B, nb] ->
        [B, kvh, M, d]: per (slot, kv-head) the rows land in table
        order. ``scale_layer`` dequantises as in :meth:`_gather_slot`."""
        g = pool_layer[tables]                         # [B,nb,kvh,BS,d]
        if scale_layer is not None:
            g = dequantize_kv_rows(g, scale_layer[tables])
        g = g.permute(0, 2, 1, 3, 4)                   # [B,kvh,nb,BS,d]
        return g.reshape(g.shape[0], g.shape[1], -1, g.shape[4])

    def _scales(self, state: DecodeState, i: int):
        """Layer ``i``'s (k, v) scale layers in int8 mode, else Nones."""
        if self.quantized:
            return state.k_scale[i], state.v_scale[i]
        return None, None

    def _slot_rows(self, state: DecodeState, i: int, slot: int,
                   table: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s K and V rows of one slot, [kvh, M, d]."""
        if not self.paged:
            m = self.max_len
            return state.k[i, slot, :, :m], state.v[i, slot, :, :m]
        sk, sv = self._scales(state, i)
        return (self._gather_slot(state.k[i], table, sk),
                self._gather_slot(state.v[i], table, sv))

    def _batch_rows(self, state: DecodeState, i: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s K and V rows of every slot, [B, kvh, M, d]."""
        if not self.paged:
            m = self.max_len
            return state.k[i, :, :, :m], state.v[i, :, :, :m]
        sk, sv = self._scales(state, i)
        return (self._gather_batch(state.k[i], state.block_tables, sk),
                self._gather_batch(state.v[i], state.block_tables, sv))

    def _write_kv(self, state: DecodeState, i: int, blk: torch.Tensor,
                  row: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
        """Scatter rows ``k``/``v`` [..., kvh, d] of layer ``i`` to the
        addresses (blk, row) [...], in place: a pool block and its row
        (paged), or a slot and its row (contiguous). Int8 mode writes the
        codes and their scales through the same addresses."""
        idx = (blk[..., None], self._kv_heads, row[..., None])
        if self.quantized:
            qk, sk = quantize_kv_rows(k)
            qv, sv = quantize_kv_rows(v)
            state.k[i][idx] = qk
            state.v[i][idx] = qv
            state.k_scale[i][idx] = sk
            state.v_scale[i][idx] = sv
            return
        state.k[i][idx] = k.to(state.k.dtype)
        state.v[i][idx] = v.to(state.v.dtype)

    def _head32(self, params: Params) -> torch.Tensor:
        """The lm head in f32, converted once per weights rather than
        per dispatch (at llama3-8b the cast is a 2.1 GB copy). Logits are
        f32 products of the bf16 values, as in the JAX engine."""
        head = self.model._head(params)
        if head.dtype == torch.float32:
            return head
        key = (head.data_ptr(), head._version, tuple(head.shape))
        if self._head32_key != key:
            self._head32_cache = None  # free the old copy first
            self._head32_cache = head.float()
            self._head32_key = key
        return self._head32_cache

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def _settings(self, value, dtype) -> torch.Tensor:
        """One admission's sampling setting as a device [1] tensor."""
        return torch.full((1,), value, dtype=dtype, device=self.device)

    def _attend_pool(self, q: torch.Tensor, k_rows: torch.Tensor,
                     v_rows: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
        """Grouped-query attention of q [N, T, hq, d] over gathered pool
        rows [N, kvh, M, d] with mask ``valid`` [N, T, M]: f32 scores,
        -1e30 masking, P cast to the model dtype before P.V (the JAX
        engine's bf16 x bf16 -> f32 einsums). Returns [N, T, hq, d]."""
        c = self.config
        n, t = q.shape[:2]
        grp = c.num_heads // c.num_kv_heads
        qg = q.reshape(n, t, c.num_kv_heads, grp, c.head_dim).float()
        s = torch.einsum('ntkgd,nkmd->ntkgm', qg, k_rows.float())
        s = s * (c.head_dim ** -0.5)
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, _NEG_INF))
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum('ntkgm,nkmd->ntkgd', p.to(c.dtype).float(),
                            v_rows.float())
        return attn.reshape(n, t, c.num_heads, c.head_dim).to(c.dtype)

    # -- prefill ------------------------------------------------------------
    def prefill(self, params: Params, tokens, true_len: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Run a single prompt [T_padded] through the model.

        Returns (k [L, kvh, T_padded, d], v, last_logits [V] f32). End
        padding is benign under causal attention; rows past ``true_len``
        are masked at decode time by the slot length."""
        tokens = self._tokens(tokens)
        if self.profiler is not None:
            self.profiler.note_variant('prefill', tokens.shape[0])
            self.profiler.prefill_tokens.inc(tokens.shape[0])
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []

        def keep(i, k, v):
            # [1, T, kvh, d] -> [kvh, T, d]: head-major, as the JAX engine.
            ks.append(k[0].transpose(0, 1))
            vs.append(v[0].transpose(0, 1))

        logits = self._prefill_forward(params, tokens[None], [true_len],
                                       keep)
        return torch.stack(ks), torch.stack(vs), logits[0]

    @torch.no_grad()
    def _prefill_forward(self, params: Params, tokens: torch.Tensor,
                         true_lens: Sequence[int], sink) -> torch.Tensor:
        """Monolithic prefill of N same-length prompts ``tokens`` [N, T];
        ``sink(layer, k [N, T, kvh, d], v)`` receives each layer's KV
        rows. Attention goes through the flash kernel on the card
        (``attention()`` dispatch), one launch per layer for all N.
        Returns the logits [N, V] of each prompt's last real token
        (``true_lens``, host ints)."""
        c = self.config
        model = self.model
        n, t = tokens.shape
        positions = torch.arange(t, device=self.device)
        x = params['embed'][tokens].to(c.dtype)  # [N, T, e]
        for i in range(c.num_layers):
            lp = model.layer_params(params, i)
            q, k, v = model._qkv(lp, x, self._cos, self._sin, positions)
            attn = attention_ops.attention(q, k, v, causal=True)
            x = x + model._attn_out(lp, attn)
            x = x + model._mlp_delta(lp, x)[0]
            sink(i, k, v)
        x = rms_norm(x, params['final_norm'], c.norm_eps)
        # Logits only for each last real token: no [N, T, V] matmul.
        if n == 1:
            last = x[0, int(true_lens[0]) - 1][None]
        else:
            rows = torch.as_tensor([int(s) - 1 for s in true_lens],
                                   device=self.device)
            last = x[torch.arange(n, device=self.device), rows]
        return last.float() @ self._head32(params)

    # -- chunked prefill ----------------------------------------------------
    def prefill_chunk(self, params: Params, state: DecodeState, tokens,
                      offset: int, slot: int,
                      table_row=None) -> DecodeState:
        """Run ONE prompt chunk [C] at cache ``offset`` of ``slot``,
        writing its KV rows in place. The chunk's queries attend to the
        slot's rows [0, offset) through its table (prefix-cache blocks
        included) plus the chunk itself, causally. The slot stays
        INACTIVE until the final chunk commits it."""
        tokens = self._tokens(tokens)
        if self.profiler is not None:
            self.profiler.note_variant('prefill_chunk', tokens.shape[0])
            self.profiler.prefill_tokens.inc(tokens.shape[0])
        table = self._table_arg(slot, table_row)
        self._chunk_forward(state, params, tokens, offset, slot, table)
        state.block_tables[slot] = table
        return state

    def prefill_chunk_final(self, params: Params, state: DecodeState,
                            tokens, offset: int, slot: int, true_len: int,
                            rng: torch.Generator, temperature: float = 0.0,
                            top_k: int = 0, table_row=None
                            ) -> Tuple[DecodeState, torch.Tensor,
                                       torch.Generator]:
        """Final chunk: forward + first-token sample + slot activation.
        Returns (state, first_token, rng). ``true_len`` is the FULL
        prompt length; padding past it is masked by the slot length."""
        tokens = self._tokens(tokens)
        if self.profiler is not None:
            self.profiler.note_variant('prefill_chunk_final',
                                       tokens.shape[0])
            self.profiler.prefill_tokens.inc(tokens.shape[0])
        c = self.config
        table = self._table_arg(slot, table_row)
        x = self._chunk_forward(state, params, tokens, offset, slot, table)
        with torch.no_grad():
            x = rms_norm(x, params['final_norm'], c.norm_eps)
            last = x[0, int(true_len) - 1 - int(offset)].float()
            logits = last @ self._head32(params)
            first = _sample(logits[None], rng,
                            self._settings(temperature, torch.float32),
                            self._settings(top_k, torch.long))[0]
        state.lengths[slot] = int(true_len)
        state.last_tokens[slot] = first
        state.active[slot] = True
        state.block_tables[slot] = table
        return state, first, rng

    @torch.no_grad()
    def _chunk_forward(self, state: DecodeState, params: Params,
                       tokens: torch.Tensor, offset: int, slot: int,
                       table: torch.Tensor) -> torch.Tensor:
        """Chunk forward over the slot's prefix KV + in-place cache
        writes. Returns x [1, C, e], the final hidden states."""
        c = self.config
        model = self.model
        t = tokens.shape[0]
        offset = int(offset)
        positions = offset + torch.arange(t, device=self.device)
        x = params['embed'][tokens][None].to(c.dtype)  # [1, C, e]
        # [1, C, M]: a chunk query at position p sees kv rows <= p.
        valid = (self._kv_pos[None, :] <= positions[:, None])[None]
        if self.paged:
            blk = table[positions // self.kv_block]   # [C]
            row = positions % self.kv_block           # [C]
        else:
            # The JAX engine's dynamic_update_slice would clamp the
            # start and shift the chunk; chunk_spans never asks for it.
            if offset + t > self.max_len:
                raise ValueError(f'chunk [{offset}, {offset + t}) runs '
                                 f'past max_len {self.max_len}')
            blk = torch.full((t,), int(slot), device=self.device)
            row = positions
        for i in range(c.num_layers):
            lp = model.layer_params(params, i)
            q, k, v = model._qkv(lp, x, self._cos, self._sin, positions)
            self._write_kv(state, i, blk, row, k[0], v[0])
            k_slot, v_slot = self._slot_rows(state, i, slot, table)
            attn = self._attend_pool(q, k_slot[None], v_slot[None], valid)
            x = x + model._attn_out(lp, attn)
            x = x + model._mlp_delta(lp, x)[0]
        return x

    # -- insert -------------------------------------------------------------
    def _prompt_addresses(self, slots: torch.Tensor, tables: torch.Tensor,
                          t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Write addresses (blk, row) [N, T] of rows [0, t) of N slots:
        through each slot's table row (paged; rows past the table's
        assignment land in the null block, never read unmasked), or the
        slot and the position (contiguous)."""
        pos = torch.arange(t, device=self.device)
        n = slots.shape[0]
        if self.paged:
            return (tables[:, pos // self.kv_block],
                    (pos % self.kv_block).expand(n, t))
        return slots[:, None].expand(n, t), pos.expand(n, t)

    def _clear_tails(self, state: DecodeState, slots: torch.Tensor,
                     t: int) -> None:
        """Contiguous mode: zero rows [t, max_len) of the admitted slots,
        as the JAX engine writes each prompt zero-extended to max_len; a
        stale row would otherwise meet its mask as 0 * inf = NaN."""
        if not self.paged and t < self.max_len:
            state.k[:, slots, :, t:self.max_len] = 0
            state.v[:, slots, :, t:self.max_len] = 0

    def _check_prompt_len(self, t: int) -> None:
        if t > self.max_len:
            raise ValueError(f'prefill length {t} exceeds max_len '
                             f'{self.max_len}')

    @torch.no_grad()
    def insert(self, state: DecodeState, k: torch.Tensor, v: torch.Tensor,
               true_len: int, last_token, slot: int,
               table_row=None) -> DecodeState:
        """Write a prefilled prompt's KV [L, kvh, T, d] into ``slot``
        (through its block table when paged) and mark the slot
        active."""
        t = k.shape[2]
        self._check_prompt_len(t)
        table = self._table_arg(slot, table_row)
        slots = torch.tensor([int(slot)], device=self.device)
        blk, row = self._prompt_addresses(slots, table[None], t)
        self._clear_tails(state, slots, t)
        for i in range(self.config.num_layers):
            self._write_kv(state, i, blk[0], row[0], k[i].transpose(0, 1),
                           v[i].transpose(0, 1))
        state.lengths[slot] = int(true_len)
        state.last_tokens[slot] = torch.as_tensor(last_token,
                                                  device=self.device)
        state.active[slot] = True
        state.block_tables[slot] = table
        return state

    def admit(self, params: Params, state: DecodeState, tokens,
              true_len: int, slot: int, rng: torch.Generator,
              temperature: float = 0.0, top_k: int = 0, table_row=None
              ) -> Tuple[DecodeState, torch.Tensor, torch.Generator]:
        """Fused prefill + first-token sample + insert: each layer's KV
        rows go straight into the cache (no [L, kvh, T, d] stack).
        Returns (state, first_token, rng)."""
        tokens = self._tokens(tokens)
        if self.profiler is not None:
            self.profiler.note_variant('admit', tokens.shape[0])
            self.profiler.prefill_tokens.inc(tokens.shape[0])
        t = tokens.shape[0]
        self._check_prompt_len(t)
        table = self._table_arg(slot, table_row)
        slots = torch.tensor([int(slot)], device=self.device)
        blk, row = self._prompt_addresses(slots, table[None], t)
        self._clear_tails(state, slots, t)

        def write(i, k, v):
            self._write_kv(state, i, blk, row, k, v)

        logits = self._prefill_forward(params, tokens[None], [true_len],
                                       write)
        with torch.no_grad():
            first = _sample(logits, rng,
                            self._settings(temperature, torch.float32),
                            self._settings(top_k, torch.long))[0]
        state.lengths[slot] = int(true_len)
        state.last_tokens[slot] = first
        state.active[slot] = True
        state.block_tables[slot] = table
        return state, first, rng

    def admit_many(self, params: Params, state: DecodeState, tokens,
                   true_lens: Sequence[int], slots: Sequence[int],
                   rng: torch.Generator, temperatures, top_ks,
                   table_rows=None
                   ) -> Tuple[DecodeState, torch.Tensor, torch.Generator]:
        """Fused BATCHED prefill + first-token sample + insert of N
        same-bucket prompts ``tokens`` [N, T]: one forward with K1 at
        batch N, one sample over [N], one scatter per layer and cache
        half for all N through their tables. Returns (state, first
        tokens [N], rng). ``true_lens`` and ``slots`` are host ints, so
        nothing here waits for the device; ``table_rows`` [N,
        max_blocks] defaults to each slot's auto assignment (paged)."""
        tokens = self._tokens(tokens)
        if tokens.dim() != 2:
            raise ValueError(f'admit_many takes tokens [N, T], got '
                             f'{tuple(tokens.shape)}')
        n, t = tokens.shape
        if self.profiler is not None:
            self.profiler.note_variant('admit_many', tuple(tokens.shape))
            self.profiler.prefill_tokens.inc(n * t)
        self._check_prompt_len(t)
        true_lens = [int(s) for s in true_lens]
        slot_ids = [int(s) for s in slots]
        if len(true_lens) != n or len(slot_ids) != n:
            raise ValueError(f'{n} prompts need {n} true_lens and slots, '
                             f'got {len(true_lens)} and {len(slot_ids)}')
        if not self.paged:
            tables = torch.zeros((n, 0), dtype=torch.long,
                                 device=self.device)
        elif table_rows is not None:
            tables = torch.as_tensor(table_rows, dtype=torch.long,
                                     device=self.device)
            if tuple(tables.shape) != (n, self.max_blocks):
                raise ValueError(f'table rows must be [{n}, '
                                 f'{self.max_blocks}], got '
                                 f'{tuple(tables.shape)}')
        else:
            tables = torch.stack([self._auto_table(s) for s in slot_ids])
        slots_t = torch.as_tensor(slot_ids, device=self.device)
        blk, row = self._prompt_addresses(slots_t, tables, t)
        self._clear_tails(state, slots_t, t)

        def write(i, k, v):
            self._write_kv(state, i, blk, row, k, v)

        logits = self._prefill_forward(params, tokens, true_lens, write)
        with torch.no_grad():
            firsts = _sample(
                logits, rng,
                torch.as_tensor(temperatures, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(top_ks, dtype=torch.long,
                                device=self.device))
        state.lengths[slots_t] = torch.as_tensor(true_lens,
                                                 device=self.device)
        state.last_tokens[slots_t] = firsts
        state.active[slots_t] = True
        if self.paged:
            state.block_tables[slots_t] = tables
        return state, firsts, rng

    def release(self, state: DecodeState, slot: int) -> DecodeState:
        """Mark a slot free and clear its table to the null block: its
        old blocks may be reassigned, and a stale table would let this
        (now inactive) slot's parked decode write land in them."""
        state.block_tables[slot] = 0
        state.lengths[slot] = 0
        state.active[slot] = False
        return state

    @torch.no_grad()
    def sample_first(self, logits: torch.Tensor, rng: torch.Generator,
                     temperature: float, top_k: int
                     ) -> Tuple[torch.Tensor, torch.Generator]:
        """Sample the TTFT token from prefill logits [V] on the device.
        Returns (token scalar tensor, rng)."""
        tok = _sample(logits[None], rng,
                      self._settings(temperature, torch.float32),
                      self._settings(top_k, torch.long))[0]
        return tok, rng

    # -- decode step --------------------------------------------------------
    SCALAR_SAMPLING_CACHE_MAX = 32

    def _scalar_sampling(self, value, dtype) -> torch.Tensor:
        """Device [B] broadcast of a scalar sampling setting, LRU-cached
        so repeated scalar defaults cost no host->device copy."""
        key = (value, str(dtype))
        cached = self._scalar_sampling_cache.get(key)
        if cached is None:
            cached = torch.full((self.batch_slots,), value, dtype=dtype,
                                device=self.device)
            self._scalar_sampling_cache[key] = cached
            while (len(self._scalar_sampling_cache)
                   > self.SCALAR_SAMPLING_CACHE_MAX):
                self._scalar_sampling_cache.popitem(last=False)
        else:
            self._scalar_sampling_cache.move_to_end(key)
        return cached

    def _per_slot(self, value, dtype, scalar_type) -> torch.Tensor:
        b = self.batch_slots
        if (isinstance(value, torch.Tensor) and tuple(value.shape) == (b,)
                and value.dtype == dtype and value.device == self.device):
            return value
        if isinstance(value, scalar_type) and not isinstance(value, bool):
            return self._scalar_sampling(value, dtype)
        return torch.as_tensor(value, dtype=dtype,
                               device=self.device).expand(b).contiguous()

    def _sampling_args(self, temperature, top_k):
        return (self._per_slot(temperature, torch.float32, (int, float)),
                self._per_slot(top_k, torch.long, int))

    # skylint: hot-path
    def step(self, params: Params, state: DecodeState, rng: torch.Generator,
             temperature=0.0, top_k=0
             ) -> Tuple[DecodeState, torch.Tensor, torch.Generator]:
        """One token for every active slot. Returns (state, sampled [B],
        rng). ``temperature``/``top_k`` are scalars or per-slot [B]."""
        temperature, top_k = self._sampling_args(temperature, top_k)
        if self.profiler is None:
            return self._step_impl(params, state, rng, temperature, top_k)
        self.profiler.note_variant('step', self.batch_slots)
        t0 = time.perf_counter()
        if self._last_dispatch_end is not None:
            self.profiler.note_gap(t0 - self._last_dispatch_end)
        out = self._step_impl(params, state, rng, temperature, top_k)
        end = time.perf_counter()
        self.profiler.note_step(end - t0)
        self._last_dispatch_end = end
        return out

    @torch.no_grad()
    def _step_impl(self, params, state, rng, temperature, top_k):
        logits = self._step_logits(params, state)
        sampled = _sample(logits, rng, temperature, top_k)
        # Clamp: a slot at capacity rewrites its last row instead of
        # running past the cache (emission lags dispatch; tokens past a
        # full slot are discarded at emission).
        state.lengths.add_(state.active.long()).clamp_(max=self.max_len - 1)
        state.last_tokens.copy_(torch.where(state.active, sampled,
                                            state.last_tokens))
        return state, sampled, rng

    @torch.no_grad()
    def _step_logits(self, params, state) -> torch.Tensor:
        """The decode step's forward: writes each slot's new KV row and
        returns the logits [B, V] f32, without sampling or advancing the
        slots (chip_smoke.py holds the int8 pool's logits against bf16's
        through it)."""
        c = self.config
        model = self.model
        positions = state.lengths[:, None]  # [B, 1]
        x = params['embed'][state.last_tokens][:, None].to(c.dtype)
        # New key written at index ``lengths`` -> valid keys <= lengths.
        valid = (self._kv_pos[None] <= state.lengths[:, None])[:, None]
        # INACTIVE slots park their (garbage) write at the LAST row, not
        # row ``lengths`` (= 0): a slot mid-chunked-prefill is inactive
        # but already holds real rows from 0 up. The last row is never
        # read before being rewritten.
        write_pos = torch.where(state.active, state.lengths,
                                torch.full_like(state.lengths,
                                                self.max_len - 1))
        if self.paged:
            blk = torch.gather(state.block_tables, 1,
                               (write_pos // self.kv_block)[:, None])[:, 0]
            row = write_pos % self.kv_block
        else:
            blk, row = self._slot_ids, write_pos
        for i in range(c.num_layers):
            lp = model.layer_params(params, i)
            q, k, v = model._qkv(lp, x, self._cos, self._sin, positions)
            self._write_kv(state, i, blk, row, k[:, 0], v[:, 0])
            k_layer, v_layer = self._batch_rows(state, i)
            attn = self._attend_pool(q, k_layer, v_layer, valid)
            x = x + model._attn_out(lp, attn)
            x = x + model._mlp_delta(lp, x)[0]
        x = rms_norm(x, params['final_norm'], c.norm_eps)
        return x[:, 0].float() @ self._head32(params)

    # -- speculative decode step --------------------------------------------
    # skylint: hot-path
    def step_verify(self, params: Params, state: DecodeState,
                    rng: torch.Generator, draft, temperature=0.0, top_k=0
                    ) -> Tuple[DecodeState, torch.Tensor, torch.Tensor,
                               torch.Generator]:
        """One VERIFY step: score ``draft`` [B, K] plus each slot's
        pending token in one [B, 1+K] forward, accept the longest greedy
        prefix and emit the corrected token after it. Returns (state,
        out [B, 1+K], accept [B], rng): slot b emits
        ``out[b, 0 .. accept[b]]``. Rejected rows roll back by LENGTH
        masking; sampling slots (temperature > 0) accept nothing."""
        draft = self._tokens(draft)
        temperature, top_k = self._sampling_args(temperature, top_k)
        if self.profiler is None:
            return self._step_verify_impl(params, state, rng, temperature,
                                          top_k, draft)
        self.profiler.note_variant('step_verify', self.batch_slots,
                                   draft.shape[1])
        t0 = time.perf_counter()
        if self._last_dispatch_end is not None:
            self.profiler.note_gap(t0 - self._last_dispatch_end)
        out = self._step_verify_impl(params, state, rng, temperature, top_k,
                                     draft)
        end = time.perf_counter()
        self.profiler.note_step(end - t0)
        self.profiler.spec_verify_ms.observe((end - t0) * 1e3)
        self._last_dispatch_end = end
        return out

    @torch.no_grad()
    def _step_verify_impl(self, params, state, rng, temperature, top_k,
                          draft):
        k_spec = draft.shape[1]
        logits = self._verify_logits(params, state, draft)     # [B, T, V]
        # Row 0 through the full sampler (greedy argmax at temperature
        # 0, the plain step's draw otherwise).
        out0 = _sample(logits[:, 0], rng, temperature, top_k)
        greedy = torch.argmax(logits, dim=-1)                    # [B, T]
        match = (draft == greedy[:, :k_spec]).long()
        accept = torch.cumprod(match, dim=1).sum(dim=1)          # [B]
        accept = torch.where(temperature > 0.0,
                             torch.zeros_like(accept), accept)
        out = torch.cat([out0[:, None], greedy[:, 1:]], dim=1)
        new_last = torch.gather(out, 1, accept[:, None])[:, 0]
        active_i = state.active.long()
        state.lengths.add_((accept + 1) * active_i).clamp_(
            max=self.max_len - 1)
        state.last_tokens.copy_(torch.where(state.active, new_last,
                                            state.last_tokens))
        return state, out, accept, rng

    @torch.no_grad()
    def _verify_logits(self, params, state, draft) -> torch.Tensor:
        """The verify step's forward over each slot's pending token and
        ``draft`` [B, K]: writes the K + 1 KV rows and returns the logits
        [B, K + 1, V] f32, without accepting or advancing the slots
        (chip_smoke.py holds them against plain steps' through it)."""
        c = self.config
        model = self.model
        k_spec = draft.shape[1]
        t = 1 + k_spec
        inputs = torch.cat([state.last_tokens[:, None], draft], dim=1)
        positions = (state.lengths[:, None]
                     + torch.arange(t, device=self.device)[None])  # [B, T]
        x = params['embed'][inputs].to(c.dtype)                 # [B, T, e]
        valid = self._kv_pos[None, None, :] <= positions[:, :, None]
        # Rows past capacity (and every row of an inactive slot) must not
        # land anywhere real. JAX gives them an out-of-range index and
        # scatters with mode='drop'; torch has no dropping scatter, and a
        # boolean filter would sync with the host every step. So they are
        # redirected to a row that is never read unmasked: the reserved
        # null block 0 (paged; an int8 row's code and scale go there
        # together, through the same address), or the slot's sink row
        # max_len (contiguous). Never clamp them onto a real row: several
        # draft rows would collide on one row a reader sees.
        ok = state.active[:, None] & (positions <= self.max_len - 1)
        wp = torch.clamp(positions, max=self.max_len - 1)
        if self.paged:
            blk = torch.gather(state.block_tables, 1, wp // self.kv_block)
            blk = torch.where(ok, blk, torch.zeros_like(blk))
            row = wp % self.kv_block
        else:
            blk = self._slot_ids[:, None].expand(-1, t)
            row = torch.where(ok, wp, torch.full_like(wp, self.max_len))
        for i in range(c.num_layers):
            lp = model.layer_params(params, i)
            q, k, v = model._qkv(lp, x, self._cos, self._sin, positions)
            self._write_kv(state, i, blk, row, k, v)
            k_layer, v_layer = self._batch_rows(state, i)
            attn = self._attend_pool(q, k_layer, v_layer, valid)
            x = x + model._attn_out(lp, attn)
            x = x + model._mlp_delta(lp, x)[0]
        x = rms_norm(x, params['final_norm'], c.norm_eps)
        return x.float() @ self._head32(params)


def draft_tokens(history: List[int], k: int, ngram: int = 3) -> List[int]:
    """Model-free prompt-lookup draft: ``k`` proposed continuation
    tokens from ``history`` (the request's prompt + emitted tokens).

    Longest-match-first n-gram backoff (Prompt Lookup Decoding): find
    the most recent EARLIER occurrence of the trailing ``n``-gram for
    n = ngram .. 1 and propose the ``k`` tokens that followed it.
    Short proposals pad by repeating the last proposed (or last history)
    token; an empty history drafts zeros.
    """
    if k <= 0:
        return []
    h = history
    n_h = len(h)
    out: List[int] = []
    for n in range(min(ngram, n_h - 1), 0, -1):
        tail = h[n_h - n:]
        for start in range(n_h - n - 1, -1, -1):
            if h[start:start + n] == tail:
                out = list(h[start + n:start + n + k])
                break
        if out:
            break
    pad = out[-1] if out else (h[-1] if h else 0)
    while len(out) < k:
        out.append(pad)
    return out[:k]


def _sample(logits: torch.Tensor, rng: torch.Generator,
            temperature: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Greedy (temperature 0) / temperature / top-k sampling on device.

    ``temperature`` f32 and ``top_k`` int64 are per-row [B] (or [1],
    broadcast); out-of-range top_k is clamped to the vocab. The draw is a
    Gumbel-max over the filtered logits, as ``jax.random.categorical``
    does, from ``rng`` (different bits from JAX's)."""
    b, v = logits.shape
    temperature = temperature.expand(b)
    top_k = top_k.expand(b)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1).values  # ascending
    kth_idx = torch.clamp(v - top_k, 0, v - 1)
    kth = torch.gather(srt, 1, kth_idx[:, None])
    kth = torch.where((top_k > 0)[:, None], kth,
                      torch.full_like(kth, float('-inf')))
    filtered = torch.where(scaled >= kth, scaled,
                           torch.full_like(scaled, float('-inf')))
    u = torch.rand(filtered.shape, generator=rng, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    sampled = torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def chunk_spans(prompt_len: int, chunk: int,
                max_len: int) -> List[Tuple[int, int, bool]]:
    """Split a prompt into prefill-chunk spans ``(offset, bucket, final)``.

    Every mid span is exactly ``chunk`` tokens; the final span pads its
    remainder up to a ``prefill_bucket`` capped at ``chunk`` and at
    ``max_len - offset`` so the cache write never runs past the slot.
    """
    if chunk <= 0:
        raise ValueError(f'chunk must be positive, got {chunk}')
    spans: List[Tuple[int, int, bool]] = []
    off = 0
    while prompt_len - off > chunk:
        spans.append((off, chunk, False))
        off += chunk
    rem = prompt_len - off
    bucket = min(prefill_bucket(rem, min(chunk, max_len)), max_len - off)
    spans.append((off, bucket, True))
    return spans


def prefill_bucket(length: int, max_len: int, floor: int = 16) -> int:
    """Smallest bucket >= length (bounded by max_len): powers of two up
    to 512, then multiples of 512 (caps padding waste at ~20%)."""
    b = floor
    while b < length and b < 512:
        b *= 2
    if length > b:
        b = (length + 511) // 512 * 512
    return min(b, max_len)
