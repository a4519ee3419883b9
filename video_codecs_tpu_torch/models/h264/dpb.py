"""H.264 decoded-picture buffer (frame coding): default list 0 and the
sliding window.

The port's copy of video_codecs_tpu/models/h264/dpb.py without list
reordering (`apply_reorder`) and adaptive marking (MMCO), which the
port's encoder never emits and its decoder rejects.  Reference-picture
list construction (spec 8.2.4 default order) and marking (spec 8.2.5.3
sliding window), shared by the encoder and the decoder so both sides
derive identical lists.

Parity: jm18.5/lcommon/src/mbuffer.c (init_lists_p_slice :1506,
sliding_window_memory_management :2576, adaptive_memory_management
:2736, mm_* ops), ldecod/src/header.c ref_pic_list_reordering :650.
"""

from __future__ import annotations

import dataclasses


# video_codecs_tpu/models/h264/dpb.py:19
@dataclasses.dataclass(eq=False)
class RefPic:
    """One reference picture: planes + marking state."""
    planes: tuple                  # (y, u, v) int32 recon
    frame_num: int = 0
    lt_idx: int | None = None      # None = short-term

    # video_codecs_tpu/models/h264/dpb.py:26
    @property
    def long_term(self) -> bool:
        return self.lt_idx is not None


# video_codecs_tpu/models/h264/dpb.py:31
class Dpb:
    """Reference picture buffer for frame-coded streams."""

    # video_codecs_tpu/models/h264/dpb.py:34
    def __init__(self, max_refs: int, log2_max_frame_num: int = 8) -> None:
        self.pics: list[RefPic] = []
        self.max_refs = max(max_refs, 1)
        self.max_fn = 1 << log2_max_frame_num
        self.max_lt_idx: int | None = None     # MaxLongTermFrameIdx

    # ---- derivation helpers (spec 8.2.4.1) ----

    # video_codecs_tpu/models/h264/dpb.py:42
    def pic_num(self, p: RefPic, cur_fn: int) -> int:
        """PicNum (== FrameNumWrap for frame coding)."""
        fn = p.frame_num
        return fn - self.max_fn if fn > cur_fn else fn

    # video_codecs_tpu/models/h264/dpb.py:47
    def idr_reset(self) -> None:
        self.pics = []
        self.max_lt_idx = None

    # video_codecs_tpu/models/h264/dpb.py:51
    def default_list0(self, cur_fn: int) -> list[RefPic]:
        """Initial RefPicList0 for a P slice: short-term by descending
        PicNum, then long-term by ascending LongTermPicNum."""
        st = sorted((p for p in self.pics if not p.long_term),
                    key=lambda p: -self.pic_num(p, cur_fn))
        lt = sorted((p for p in self.pics if p.long_term),
                    key=lambda p: p.lt_idx)
        return st + lt

    # ---- marking (spec 8.2.5) ----

    # video_codecs_tpu/models/h264/dpb.py:102
    def mark(self, cur: RefPic) -> None:
        """Insert the just-decoded reference picture; sliding window."""
        self.pics.append(cur)
        self._enforce_window(keep=cur)

    # video_codecs_tpu/models/h264/dpb.py:153
    def _enforce_window(self, keep: RefPic) -> None:
        """Sliding window: evict the oldest short-term while over
        capacity (spec 8.2.5.3)."""
        while len(self.pics) > self.max_refs:
            st = [p for p in self.pics if not p.long_term and p is not keep]
            if not st:
                st = [p for p in self.pics if not p.long_term]
            if not st:
                break                      # all long-term: nothing to evict
            oldest = min(st, key=lambda p: self.pic_num(p, keep.frame_num))
            self.pics.remove(oldest)
