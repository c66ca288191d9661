"""Copied from ``hevc_tpu/cabac/__init__.py`` at e99b487."""
from .engine import CabacDecoder, CabacEncoder
from .ctx import ContextModel, init_context_states, CTX_OFFSET, CTX_COUNT, TOTAL_CONTEXTS
