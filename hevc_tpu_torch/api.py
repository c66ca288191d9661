"""Public decoder API of the PyTorch/CUDA port — capability parity with
libopenhevc (reference:
libopenhevc/openhevc.h:161-373, openhevc.c): handle lifecycle
(init/start/decode/flush/close), hvcC or Annex-B extradata, per-AU
decode returning at most one display picture, layer/temporal selection,
SEI-checksum toggle, frame info + cropped copy-out, log control.

The reference wires up to MAX_DECODERS=3 per-layer decoder instances and
fans each AU out to all of them (openhevc.c:30, :236-283); here one
`Decoder` already routes NALs per nuh_layer_id internally, so the handle
is a thin orchestration shim — layer fan-out is a dict of layer
contexts, not OS threads.

Copied from ``hevc_tpu/api.py`` at 834e19a.  A handle decodes with
``recon_backend="torch"`` (the port's frame program) on ``device``: None
is the current CUDA device, and a caller that wants the CPU asks for
``"cpu"``; ``"inline"`` and ``"plan"`` are the NumPy backends.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import log as ohlog
from . import trace
from .bitstream import nal as nalmod
from .decoder.core import DecodedFrame, Decoder

OH_THREAD_FRAME = 1
OH_THREAD_SLICE = 2
OH_THREAD_FRAMESLICE = 4


@dataclass
class OHFrameInfo:
    """Mirror of openhevc.h OHFrameInfo (:93-115)."""
    width: int = 0
    height: int = 0
    bit_depth: int = 8
    chroma_format: int = 1  # 0=4:0:0 1=4:2:0 2=4:2:2 3=4:4:4
    linesize: Tuple[int, int, int] = (0, 0, 0)
    framerate: Tuple[int, int] = (0, 1)
    sample_aspect_ratio: Tuple[int, int] = (1, 1)
    display_picture_number: int = 0
    pts: int = 0


@dataclass
class OHFrame:
    planes: List[np.ndarray]
    info: OHFrameInfo
    side_data: Optional[dict] = None
    md5_ok: Optional[bool] = None


class LayerSelect:
    """Output selection of a layered decode: one picture an access unit,
    that of the highest layer up to ``layer`` that the access unit
    carries, in the order the decoder outputs them.

    A lower layer's picture is held until its access unit's upper layer
    has been decoded, and is then dropped (never fetched); it is delivered
    only if the access unit turns out to carry no such layer, which is
    known once the next access unit begins or the decoder is flushed.
    Pictures behind a held one wait with it.  Counts ``api_layer_held``
    (lower-layer pictures still held when a call returns) and
    ``api_layer_dropped``."""

    def __init__(self, layer: int):
        self.layer = layer
        self.held: List[DecodedFrame] = []

    def __call__(self, frames: List[DecodedFrame]) -> List[DecodedFrame]:
        """The pictures to deliver, of those held and ``frames``."""
        out, wait = [], []
        n_old, dropped, held = len(self.held), 0, 0
        for i, f in enumerate(self.held + frames):
            au = f.access_unit
            if au.top > f.layer:
                dropped += 1
            elif wait or not (au.closed or f.layer >= self.layer):
                wait.append(f)
                held += i >= n_old and f.layer < self.layer
            else:
                out.append(f)
        self.held = wait
        if held:
            trace.count("api_layer_held", held)
        if dropped:
            trace.count("api_layer_dropped", dropped)
        return out


class OHHandle:
    """One decode session.  `layers` > 1 enables SHVC multi-layer decode
    (the analogue of oh_init_lhvc)."""

    def __init__(self, nb_shards: int = 1, thread_type: int = OH_THREAD_SLICE,
                 layers: int = 1, recon_backend: str = "torch", device=None):
        self.nb_shards = nb_shards
        self._device = device
        self.thread_type = thread_type
        self.max_layers = layers
        self._backend = recon_backend
        self._active_layer = layers - 1
        self._temporal_layer = 7
        self._check_md5 = False
        self._started = False
        self._dec: Optional[Decoder] = None
        self._out_fifo: List[OHFrame] = []
        self._select = LayerSelect(self._active_layer)
        self._display_no = 0

    # ---- configuration (before or after start) --------------------------
    def select_active_layer(self, layer_id: int) -> None:
        """oh_select_active_layer (openhevc.h:351): decode up to layer."""
        self._active_layer = self._select.layer = layer_id
        if self._dec:
            self._dec.target_layer = layer_id

    def select_temporal_layer(self, tid: int) -> None:
        """oh_select_temporal_layer (openhevc.h:360)."""
        self._temporal_layer = tid
        if self._dec:
            self._dec.temporal_layer = tid

    def enable_sei_checksum(self, enable: bool = True) -> None:
        """oh_enable_sei_checksum (openhevc.c:806)."""
        self._check_md5 = enable
        if self._dec:
            self._dec.check_md5 = enable

    @staticmethod
    def set_log_level(level: int) -> None:
        ohlog.set_log_level(level)

    @staticmethod
    def set_log_callback(cb) -> None:
        ohlog.set_log_callback(cb)

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        """oh_start (openhevc.h:197): construct the layer decoders."""
        self._dec = Decoder(check_md5=self._check_md5,
                            recon_backend=self._backend,
                            target_layer=self._active_layer,
                            temporal_layer=self._temporal_layer,
                            device=self._device)
        self._started = True
        ohlog.log(ohlog.OH_LOG_VERBOSE,
                  f"started: layers<={self._active_layer} "
                  f"tid<={self._temporal_layer} backend={self._backend}")

    def extradata_cpy(self, extradata: bytes) -> None:
        """oh_extradata_cpy (openhevc.h:249): accept hvcC or Annex-B
        parameter sets (the analogue of hevc_decode_extradata,
        hevcdec.c:4100)."""
        assert self._started, "call start() first"
        if extradata[:1] == b"\x01":  # hvcC configurationVersion == 1
            from .io.mp4 import parse_hvcc
            for n in parse_hvcc(extradata).param_set_nals():
                self._dec.decode_nal(n)
        else:
            for n in nalmod.split_annexb(extradata):
                self._dec.decode_nal(n)

    def decode(self, packet: Optional[bytes], pts: int = 0):
        """oh_decode (openhevc.h:214): feed one AU (None/empty = drain
        request).  Returns (got_picture, OHFrame|None): the next picture
        in display order, one an access unit (``LayerSelect``)."""
        assert self._started, "call start() first"
        with trace.span("api_decode", pic=pts):
            if packet:
                self._dec.next_pts = pts
                for n in nalmod.split_annexb(packet):
                    self._dec.decode_nal(n)
            else:
                self._dec.flush()
            self._collect()
        if self._out_fifo:
            return True, self._out_fifo.pop(0)
        return False, None

    def flush(self) -> None:
        """Drop decode state, keep parameter sets semantics of
        avcodec_flush_buffers: here we simply drain."""
        if self._dec:
            self._dec.flush()
            self._collect()

    def close(self) -> List[OHFrame]:
        """oh_close: drain everything and release; returns trailing
        pictures (the reference's final bumping, openhevc.c:847-870)."""
        if not self._dec:
            return []
        self._dec.flush()
        self._collect()
        self._dec.close()
        out, self._out_fifo = self._out_fifo, []
        self._select.held = []
        self._dec = None
        self._started = False
        return out

    # ---- output ----------------------------------------------------------
    def _collect(self) -> None:
        """Queue the decoder's finished pictures that the output selection
        delivers (per access unit across calls; the reference selects
        among one call's pictures, openhevc.c:553-562)."""
        frames, self._dec.frames = self._dec.frames, []
        for f in self._select(frames):
            self._out_fifo.append(self._wrap(f))

    def _wrap(self, f: DecodedFrame) -> OHFrame:
        y = f.planes[0]
        info = OHFrameInfo(
            width=y.shape[1], height=y.shape[0],
            bit_depth=f.bit_depth,
            chroma_format=f.chroma_format,
            linesize=tuple(p.shape[1] for p in f.planes),
            display_picture_number=self._display_no,
            # pts travels with the picture (captured at its first slice),
            # so B-frame reorder emits each picture's own timestamp
            pts=f.pts,
        )
        self._display_no += 1
        return OHFrame(planes=f.planes, info=info,
                       side_data=f.side_data, md5_ok=f.md5_ok)


def oh_init(nb_shards: int = 1, thread_type: int = OH_THREAD_SLICE,
            device=None) -> OHHandle:
    """Single-layer HEVC session (openhevc.h:161 oh_init) on ``device``."""
    return OHHandle(nb_shards, thread_type, layers=1, device=device)


def oh_init_lhvc(nb_shards: int = 1, thread_type: int = OH_THREAD_SLICE,
                 device=None) -> OHHandle:
    """Layered (SHVC) session (openhevc.h:174 oh_init_lhvc) on ``device``.

    Decodes the base layer and the enhancement layer; the inter-layer
    reference is upsampled (and colour-mapped, with CGS) from the base
    layer's device DPB on ``device``.  One picture comes out an access
    unit, of the highest layer it carries up to the active layer
    (``select_active_layer``, by default the enhancement layer)."""
    return OHHandle(nb_shards, thread_type, layers=2, device=device)
