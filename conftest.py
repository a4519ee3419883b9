"""Keep long pytest runs under the kernel's memory-map limit and inside
their time limit.

Every program XLA compiles for the CPU keeps its code in memory maps of
its own, and JAX's caches hold the programs for the life of the process.
One random-access encode test leaves about 20,000 maps behind, and a
process that passes `vm.max_map_count` (65,530 by default) dies in the
next compile with a segmentation fault: a pytest-xdist worker that is
handed three such tests in a row crashes, whichever tests they are.
After each test this drops JAX's caches once the process holds more
than a quarter of the limit, which frees those maps.

It also has pytest-xdist hand tests to its workers one at a time
(`--maxschedchunk 1`) unless the command line sets a chunk.  By default
`--dist load` deals out runs of neighbouring tests, and the six HEVC
random-access tests of tests/test_inter_qt.py (about 3 minutes each)
sit next to each other, so one worker often gets them all: a serial
chain of about 20 minutes that decides the length of the whole run.

Most of a run's time is XLA compiling the JAX package's encoders, and
the same programs are compiled again and again: by the JAX package's
tests and by the port's parity tests that run the same encoder at the
same size, in every xdist worker, and again in a worker after the
memory-map guard above has dropped its caches.  So every process of a
run shares one JAX persistent compilation cache
(`jax_compilation_cache_dir`): a directory under `tempfile.gettempdir()`
named from the run's pytest-xdist id (PYTEST_XDIST_TESTRUNUID), which
the process that owns the run (xdist's controller, or the one pytest
process) creates and removes at its end.  A program that took at least
JAX_CACHE_MIN_COMPILE_S to compile is written there and read back, not
compiled, by the next process that needs it.  A program read back is
the compiled program that was written, so results do not change.  XLA
logs "Loading XLA:CPU AOT result. Target machine feature
+prefer-no-gather (+prefer-no-scatter) is not supported on the host
machine" on such a load: those are LLVM tuning flags of the compile
options, not instruction-set features, and the machine that loads is
the one that compiled.

The machine's cores are the other limit: a run keeps them busy, and
each xdist worker's torch would otherwise start an intra-op pool of
every core, so a worker's torch gets its share of them.

A program is read back only once it has been written, so a test that
needs another's programs should start after it, and no long test
should start last.  So the collection is reordered (the same way in
every worker): first each port parity test of _TWINS right behind the
JAX package's test that compiles the same encoder at the same size --
xdist's first deal gives each worker two tests in a row, so the twin
runs on the same worker once its leader has finished -- then the other
known long tests of _LONG_S, longest first, paired longest with
shortest where they fill that first deal (a leader's second follower
after them), then the rest in their order.  The order changes no
test's outcome.
"""

import gc
import os
import shutil
import sys
import tempfile
import uuid

import pytest

#: programs that compile faster than this are not written to the shared
#: cache (seconds; JAX's default is 1.0)
JAX_CACHE_MIN_COMPILE_S = 0.2


#: (leader, follower): the follower compiles the leader's JAX encoder at
#: the leader's size and settings, so it reads the leader's programs
#: from the shared cache when it runs after it (and, on the same worker,
#: the eager operations the leader compiled)
_TWINS = (
    ("tests/test_inter_qt.py::test_qt_ra_cu8_and_multiref_roundtrip",
     "tests/test_torch_hevc_ra.py::test_ra_cu8_two_refs_per_list"),
    ("tests/test_inter_qt.py::test_qt_ra_general_decoder_roundtrip",
     "tests/test_torch_hevc_ra.py::"
     "test_ra_96x64_gop9_streams_decoders_and_stages"),
    ("tests/test_inter_qt.py::test_qt_ra_boundary_ctbs",
     "tests/test_torch_hevc_ra.py::test_ra_80x48_boundary_ctbs"),
    ("tests/test_inter_qt.py::test_qt_ra_sao_roundtrip",
     "tests/test_torch_hevc_sao.py::"
     "test_ra_sao_stream_equals_jax_and_decodes"),
    ("tests/test_inter_jax.py::test_device_ra_gop8_roundtrip",
     "tests/test_torch_hevc_flat_b.py::"
     "test_flat_ra_gop8_64x48_streams_decoder_and_stages"),
    ("tests/test_inter_jax.py::test_device_hierb_roundtrip",
     "tests/test_torch_hevc_flat_b.py::"
     "test_flat_hierb_64x48_streams_decoder_and_stages"),
    ("tests/test_inter_jax.py::test_device_ldp_roundtrip[4-True-True]",
     "tests/test_torch_hevc_sao.py::"
     "test_general_decoder_decodes_jax_ldp_sao_stream"),
    ("tests/test_inter_codec.py::test_ldp_roundtrip",
     "tests/test_torch_hevc_host_ldp.py::test_ldp_roundtrip_64x48"),
    ("tests/test_inter_codec.py::"
     "test_ldp_multiref_merge5_tmvp_hm_conformance",
     "tests/test_torch_hevc_host_ldp.py::"
     "test_ldp_multiref_merge5_tmvp_80x48"),
    ("tests/test_inter_codec.py::"
     "test_ctu_rate_control_cu_qp_delta_conformance",
     "tests/test_torch_hevc_host_ldp.py::"
     "test_ctu_rate_control_cu_qp_delta_80x48"),
    ("tests/test_inter_jax.py::test_device_ldp_roundtrip[4-True-True]",
     "tests/test_torch_hevc_host_ldp.py::"
     "test_device_ldp_sao_full_rdoq_64x48"),
    ("tests/test_ra_codec.py::test_ra_gop8_roundtrip_and_order",
     "tests/test_torch_hevc_host_b.py::test_ra_gop8_80x48"),
    ("tests/test_bframes.py::test_bframes_roundtrip",
     "tests/test_torch_hevc_host_b.py::test_hierb_moving_clip_64x48"),
    ("tests/test_h264_bslice.py::test_b_partitions_roundtrip_and_engage"
     "[cabac]",
     "tests/test_torch_h264_high_b.py::test_b_stream_partitions_96x64"
     "[cabac]"),
    ("tests/test_h264_bslice.py::test_b_partitions_roundtrip_and_engage"
     "[cavlc]",
     "tests/test_torch_h264_high_b.py::test_b_stream_partitions_96x64"
     "[cavlc]"),
    ("tests/test_h264_bslice.py::test_b_display_reorder[2]",
     "tests/test_torch_h264_high_b.py::test_b_stream_64x48[cabac-2]"),
    ("tests/test_intra_refresh.py::"
     "test_intra_refresh_forces_intra_on_static_content",
     "tests/test_torch_h264_conf.py::"
     "test_intra_refresh_forces_intra_on_static_content"),
    ("tests/test_h264_conceal.py::test_conceal_fills_lost_frame",
     "tests/test_torch_h264_conf.py::test_conceal_fills_lost_frame"),
    ("tests/test_metrics_tools.py::test_saliency_and_lambda_weights",
     "tests/test_torch_h264_conf.py::"
     "test_perceptual_stream_equal[att+ssim-size0]"),
    ("tests/test_tiles.py::test_shard_map_tiles_match_host[2]",
     "tests/test_torch_hevc_tiles.py::test_tile_batch_equals_jax_shard_map"),
    ("tests/test_encoder_jax.py::test_fast_path_matches_host_path",
     "tests/test_torch_hevc_tiles.py::test_wpp_equals_jax_and_decodes"),
    ("tests/test_quadtree.py::test_quadtree_roundtrip[4]",
     "tests/test_torch_hevc_tiles.py::"
     "test_quadtree_intra_encoder_equals_jax[ctb16]"),
    ("tests/test_quadtree.py::test_quadtree_roundtrip[5]",
     "tests/test_torch_hevc_tiles.py::"
     "test_quadtree_intra_encoder_equals_jax[ctb32]"),
    ("tests/test_quadtree.py::test_dump_mode_statistics",
     "tests/test_torch_hevc_tiles.py::test_dump_mode_statistics_equals_jax"),
)

#: seconds of the other long tests in a 6-worker run without the shared
#: cache (its junit file); they only order the tests
_LONG_S = {
    "tests/test_inter_qt.py::test_qt_merging_engages_and_saves_bits": 494,
    "tests/test_inter_qt.py::test_qt_ra_tmvp_roundtrip": 419,
    "tests/test_torch_hevc_rc.py::test_ldp_rate_control_stream_and_resume":
        285,
    "tests/test_torch_hevc_ra.py::test_ra_headline_settings_tmvp": 193,
    "tests/test_torch_hevc_ldp.py::test_ldp_tz_four_refs": 184,
    "tests/test_torch_hevc_ldp.py::test_ldp_four_refs_tmvp_merge5_sbh": 182,
    "tests/test_torch_hevc_ra.py::test_ra_tz_cu8": 134,
    "tests/test_torch_hevc_intra.py::test_quadtree_path_equal"
    "[80x48-qp32-lite]": 91,
    "tests/test_inter_jax.py::test_device_ldp_uses_inter_blocks": 85,
    "tests/test_ratectrl.py::test_hm_ratecontrol_hits_target_30_frames": 83,
    "tests/test_torch_hevc_ldp.py::test_ldp_one_ref_no_tmvp": 83,
    "tests/test_inter_jax.py::test_device_ldp_roundtrip[1-False-False]": 79,
    "tests/test_ra_codec.py::test_ra_gop8_roundtrip_and_order": 67,
    "tests/test_torch_hevc_intra.py::test_quadtree_path_equal"
    "[96x64-qp30-lite]": 63,
    "tests/test_inter_codec.py::"
    "test_ldp_multiref_merge5_tmvp_hm_conformance": 59,
    "tests/test_config_apps.py::test_encoder_decoder_apps_roundtrip": 47,
    "tests/test_torch_cli.py::test_cli_matches_jax[intra-fast]": 40,
    "tests/test_torch_cli.py::test_cli_matches_jax[ldp]": 33,
    "tests/test_torch_cli.py::test_cli_matches_jax[ra]": 32,
    "tests/test_inter_codec.py::"
    "test_ctu_rate_control_cu_qp_delta_conformance": 44,
    "tests/test_torch_hevc_intra.py::test_quadtree_path_equal"
    "[80x48-qp30-hard]": 42,
    "tests/test_torch_hevc_intra.py::test_quadtree_path_equal"
    "[96x64-qp32-hard]": 41,
    "tests/test_inter_codec.py::test_ldp_sao_hm_conformance": 41,
    "tests/test_tiles.py::test_shard_map_tiles_match_host[4]": 39,
    "tests/test_torch_multichip.py::"
    "test_tiled_ra_equals_jax_sharded_and_stages": 150,
    "tests/test_torch_multichip.py::test_dryrun_multichip_on_cpu_devices": 90,
    "tests/test_torch_multichip.py::"
    "test_encode_b_frame_dev_me_fields_equal_jax": 40,
    "tests/test_rdoq.py::test_quadtree_full_rdoq_roundtrip": 38,
}


def _order_tests(items, workers: int) -> list:
    """_TWINS pairs, then the _LONG_S tests longest first (the first
    deal's remaining pairs longest with shortest), then the rest."""
    by_id = {it.nodeid: it for it in items}
    head, late, leaders = [], [], set()
    for lead, follow in _TWINS:
        if lead not in by_id or follow not in by_id:
            continue
        if lead in leaders:
            # a leader's second follower starts after the long tests,
            # once the leader's programs are in the shared cache
            late.append(by_id[follow])
            continue
        leaders.add(lead)
        head += [by_id[lead], by_id[follow]]
    twins = {t for pair in _TWINS for t in pair}
    long_ = sorted((t for t in _LONG_S if t in by_id and t not in twins),
                   key=lambda t: -_LONG_S[t])
    k = max(0, min(2 * workers - len(head), len(long_)) // 2)
    deal = long_[:2 * k]
    for i in range(k):
        head += [by_id[deal[i]], by_id[deal[2 * k - 1 - i]]]
    head += [by_id[t] for t in long_[2 * k:]] + late
    placed = {id(it) for it in head}
    return head + [it for it in items if id(it) not in placed]


def pytest_collection_modifyitems(config, items):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    items[:] = _order_tests(items, workers)


def _map_limit():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


def _maps_held():
    with open("/proc/self/maps", "rb") as f:
        return sum(1 for _ in f)


_LIMIT = _map_limit()


def _cache_dir(run_id: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"jax-compile-cache-{run_id}")


def _share_jax_compiles(config) -> None:
    """Point JAX's persistent compilation cache at the run's directory;
    the owning process records the directory for pytest_unconfigure."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run_id is None:
        if getattr(config.option, "numprocesses", None) and \
                hasattr(config.option, "testrunuid"):
            # xdist's controller: fix the run's id, which its workers
            # receive as PYTEST_XDIST_TESTRUNUID; it compiles nothing
            if config.option.testrunuid is None:
                config.option.testrunuid = uuid.uuid4().hex
            config._jax_cache_owned = _cache_dir(config.option.testrunuid)
            return
        run_id = uuid.uuid4().hex          # one pytest process
        config._jax_cache_owned = _cache_dir(run_id)
    try:
        import jax
    except ImportError:
        return
    path = _cache_dir(run_id)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      JAX_CACHE_MIN_COMPILE_S)


def _share_cores() -> None:
    """In a pytest-xdist worker, give torch's intra-op pool the worker's
    share of the cores: each worker's default pool is every core, and
    six of them oversubscribe the machine."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers < 2:
        return
    try:
        import torch
    except ImportError:
        return
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


def pytest_configure(config):
    if getattr(config.option, "maxschedchunk", 0) is None:
        config.option.maxschedchunk = 1
    _share_jax_compiles(config)
    _share_cores()


def pytest_unconfigure(config):
    path = getattr(config, "_jax_cache_owned", None)
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    yield
    jax = sys.modules.get("jax")
    if jax is None or _LIMIT is None:
        return
    if _maps_held() > _LIMIT // 4:
        jax.clear_caches()
        gc.collect()
