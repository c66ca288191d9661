"""Frozen copy of ``hevc_tpu_torch/cabac/__init__.py`` at ee5ffe9."""
from .engine import CabacDecoder, CabacEncoder
from .ctx import ContextModel, init_context_states, CTX_OFFSET, CTX_COUNT, TOTAL_CONTEXTS
