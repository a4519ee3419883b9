"""CABAC context layout + initialization values (spec Tables 9-5..9-32).

The port's copy of video_codecs_tpu/entropy/ctx.py, whole and as it is;
each function keeps its name and a comment gives the original's line.

Parity reference: hm-16.5rc1/source/Lib/TLibCommon/ContextTables.h:168-500
(INIT_* tables; CNU = 154) and ContextTables.h:45-132 (context counts).
Slice-type rows follow HM's enum order: B=0, P=1, I=2.

All contexts live in one flat array; OFFSETS maps element name -> start.
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy import cabac

CNU = 154

B, P, I = 0, 1, 2

# (name, count, [init_B, init_P, init_I])
_ELEMENTS: list[tuple[str, int, list[list[int]]]] = [
    ("transquant_bypass", 1, [[154], [154], [154]]),
    ("split_cu_flag", 3, [[107, 139, 126], [107, 139, 126], [139, 141, 157]]),
    ("skip_flag", 3, [[197, 185, 201], [197, 185, 201], [CNU] * 3]),
    ("merge_flag", 1, [[154], [110], [CNU]]),
    ("merge_idx", 1, [[137], [122], [CNU]]),
    ("part_size", 4, [[154, 139, 154, 154], [154, 139, 154, 154],
                      [184, CNU, CNU, CNU]]),
    ("pred_mode", 1, [[134], [149], [CNU]]),
    ("prev_intra_luma_pred", 1, [[183], [154], [184]]),
    ("chroma_pred_mode", 2, [[152, 139], [152, 139], [63, 139]]),
    ("inter_dir", 5, [[95, 79, 63, 31, 31], [95, 79, 63, 31, 31], [CNU] * 5]),
    ("mvd", 2, [[169, 198], [140, 198], [CNU] * 2]),
    ("ref_idx", 2, [[153, 153], [153, 153], [CNU] * 2]),
    ("dqp", 3, [[154] * 3, [154] * 3, [154] * 3]),
    ("chroma_qp_adj_flag", 1, [[154], [154], [154]]),
    ("chroma_qp_adj_idc", 1, [[154], [154], [154]]),
    ("cbf_luma", 5, [[153, 111, CNU, CNU, CNU], [153, 111, CNU, CNU, CNU],
                     [111, 141, CNU, CNU, CNU]]),
    ("cbf_chroma", 5, [[149, 92, 167, 154, 154], [149, 107, 167, 154, 154],
                       [94, 138, 182, 154, 154]]),
    ("qt_root_cbf", 1, [[79], [79], [CNU]]),
    ("last_x", 30, [
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
         108, 123, 93] + [CNU] * 12,
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108] + [CNU] * 12,
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63] + [CNU] * 12,
    ]),
    ("last_y", 30, [
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
         108, 123, 93] + [CNU] * 12,
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108] + [CNU] * 12,
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63] + [CNU] * 12,
    ]),
    ("sig_cg", 4, [[121, 140, 61, 154], [121, 140, 61, 154],
                   [91, 171, 134, 141]]),
    ("sig_flag", 44, [
        # 28 luma then 16 chroma (ContextTables.h:384-415)
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 140,
         170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183,
         140, 140],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 140,
         170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183,
         140, 140],
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 141,
         140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139,
         111, 111],
    ]),
    ("one_flag", 24, [
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
    ]),
    ("abs_flag", 6, [[107, 167, 91, 107, 107, 167],
                     [107, 167, 91, 122, 107, 167],
                     [138, 153, 136, 167, 152, 152]]),
    ("mvp_idx", 1, [[168], [168], [CNU]]),
    ("sao_merge", 1, [[153], [153], [153]]),
    ("sao_type", 1, [[160], [185], [200]]),
    ("trans_subdiv", 3, [[224, 167, 122], [124, 138, 94], [153, 138, 138]]),
    ("transform_skip", 2, [[139, 139], [139, 139], [139, 139]]),
    ("rdpcm_flag", 2, [[139, 139], [139, 139], [CNU, CNU]]),
    ("rdpcm_dir", 2, [[139, 139], [139, 139], [CNU, CNU]]),
    ("cross_comp", 10, [[154] * 10, [154] * 10, [154] * 10]),
    # asymmetric-motion-partition refinement bin (ContextTables.h
    # INIT_CU_AMP_POS)
    ("amp", 1, [[154], [154], [CNU]]),
]

OFFSETS: dict[str, int] = {}
_off = 0
for _name, _count, _inits in _ELEMENTS:
    OFFSETS[_name] = _off
    _off += _count
NUM_CTX = _off

INIT_VALUES = np.zeros((3, NUM_CTX), np.uint8)
for _sl in range(3):
    _off = 0
    for _name, _count, _inits in _ELEMENTS:
        assert len(_inits[_sl]) == _count, _name
        INIT_VALUES[_sl, _off:_off + _count] = _inits[_sl]
        _off += _count


# video_codecs_tpu/entropy/ctx.py:116
def init_states(slice_type: int, qp: int) -> np.ndarray:
    """Fresh packed-128 context state array for a slice."""
    return cabac.init_context_states(INIT_VALUES[slice_type], qp)


# video_codecs_tpu/entropy/ctx.py:121
def off(name: str, idx: int = 0) -> int:
    return OFFSETS[name] + idx

