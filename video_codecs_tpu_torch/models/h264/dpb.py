"""H.264 decoded-picture-buffer command surface (frame coding).

The port's copy of video_codecs_tpu/models/h264/dpb.py, whole: each
function and class under its own name, with a comment giving the
original's line.

Reference-picture list construction (spec 8.2.4: default order +
ref_pic_list_modification), and reference-picture marking (spec 8.2.5:
sliding window + adaptive MMCO 1-6).  Shared by the encoder (which
emits the commands) and the decoder (which applies the parsed ones) so
both sides derive identical lists.

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

    # ---- ref_pic_list_modification (spec 8.2.4.3) ----

    # video_codecs_tpu/models/h264/dpb.py:62
    def apply_reorder(self, lst: list[RefPic], cmds, cur_fn: int,
                      n_active: int) -> list[RefPic]:
        """cmds: [(op, arg)] with op 0/1 (abs_diff_pic_num, already +1)
        or 2 (long_term_pic_num); returns the reordered list truncated
        to n_active."""
        lst = list(lst) + [None]               # room for the shift
        pred = cur_fn
        idx = 0
        for op, arg in cmds:
            if op in (0, 1):
                no_wrap = pred - arg if op == 0 else pred + arg
                no_wrap += self.max_fn if no_wrap < 0 else 0
                no_wrap -= self.max_fn if no_wrap >= self.max_fn else 0
                pred = no_wrap
                pic_num = no_wrap - (self.max_fn if no_wrap > cur_fn else 0)
                pic = next((p for p in self.pics
                            if not p.long_term and
                            self.pic_num(p, cur_fn) == pic_num), None)
                if pic is None:
                    raise ValueError(
                        f"ref_pic_list_modification: no short-term picture "
                        f"with PicNum {pic_num} in DPB (frame_num {cur_fn})")
            else:
                pic = next((p for p in self.pics
                            if p.long_term and p.lt_idx == arg), None)
                if pic is None:
                    raise ValueError(
                        f"ref_pic_list_modification: no long-term picture "
                        f"with LongTermFrameIdx {arg} in DPB")
            # shift: insert at idx, remove the later duplicate
            lst.insert(idx, pic)
            for j in range(idx + 1, len(lst)):
                if lst[j] is pic:
                    del lst[j]
                    break
            idx += 1
        return [p for p in lst if p is not None][:n_active]

    # ---- marking (spec 8.2.5) ----

    # video_codecs_tpu/models/h264/dpb.py:102
    def mark(self, cur: RefPic, mmco=None) -> None:
        """Insert the just-decoded reference picture, applying adaptive
        MMCO commands [(op, *args)] or the sliding window."""
        if mmco:
            cur_is_lt = False
            for cmd in mmco:
                op = cmd[0]
                if op == 1:      # unmark short-term
                    pn = cur.frame_num - cmd[1]
                    self.pics = [p for p in self.pics if p.long_term or
                                 self.pic_num(p, cur.frame_num) != pn]
                elif op == 2:    # unmark long-term
                    self.pics = [p for p in self.pics
                                 if not (p.long_term and
                                         p.lt_idx == cmd[1])]
                elif op == 3:    # short-term -> long-term
                    # Spec 8.2.5.4.3: a picture already holding this
                    # LongTermFrameIdx is unmarked first (JM
                    # mm_assign_long_term_frame_idx).
                    pn = cur.frame_num - cmd[1]
                    self.pics = [p for p in self.pics
                                 if not (p.long_term and
                                         p.lt_idx == cmd[2])]
                    for p in self.pics:
                        if not p.long_term and \
                                self.pic_num(p, cur.frame_num) == pn:
                            p.lt_idx = cmd[2]
                elif op == 4:    # max_long_term_frame_idx_plus1
                    self.max_lt_idx = cmd[1] - 1 if cmd[1] else None
                    self.pics = [p for p in self.pics
                                 if not p.long_term or
                                 (self.max_lt_idx is not None and
                                  p.lt_idx <= self.max_lt_idx)]
                elif op == 5:    # reset
                    self.idr_reset()
                elif op == 6:    # current -> long-term
                    # Spec 8.2.5.4.6: drop any picture already marked
                    # with this LongTermFrameIdx (JM
                    # mm_mark_current_picture_long_term).
                    self.pics = [p for p in self.pics
                                 if not (p.long_term and
                                         p.lt_idx == cmd[1])]
                    cur.lt_idx = cmd[1]
                    cur_is_lt = True
            self.pics.append(cur)
            if not cur_is_lt:
                self._enforce_window(keep=cur)
        else:
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
