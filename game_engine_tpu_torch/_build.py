"""Build csrc/ at first use and load it with ctypes.

The CUDA kernels (csrc/rollout.cu, lossgrad.cu, search.cu, chat_decode.cu,
observe.cu)
are compiled by nvcc for sm_90a into shared libraries with a plain C
interface; the host harnesses (the kernels' bodies and stages, compiled by
g++) serve the CPU tests, and csrc/gamesim.cpp (the native per-room
simulator) is built by g++ -O3 for the native backend. All land in
build/kernels/ at the repository root, named by a hash of every source in
csrc/ and the compiler command, so an unchanged tree is built once and an
edit to any source or header rebuilds.
A failed build raises with the compiler's output. Builds are serialised
within a process (threads of the HTTP server may ask for the same library
at once) and written to a per-process temporary file across processes.
``libs_ready`` records each library this process made ready, with when and
how long it took and whether it was built or only found and loaded;
``build_log`` gives a built library's compiler report.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "kernels")
_SOURCE_EXTS = (".cu", ".cuh", ".cpp", ".h", ".hpp")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# bools, nums, strs, pdict, odict, present, regs, scal, eps, B, num_steps,
# auto_reset
_ROLLOUT_ARGS = [_P] * 9 + [_I64, _I, _I]
# ST: state (15 addresses), actions, B; state, out, actions, keep, ended, B;
# state, out, B; state, out, actions, ended, winner, reward, rw_mode,
# rw_team_slot, codes, n_codes, B
_BOTS_ARGS = [_P, _P, _I64]
_STEP_ARGS = [_P, _P, _P, _P, _P, _I64]
_RESET_ARGS = [_P, _P, _I64]
_STEP_RESET_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I64]
_ST_ENTRIES = (("ge_bots", _BOTS_ARGS), ("ge_step", _STEP_ARGS),
               ("ge_reset_done", _RESET_ARGS), ("ge_step_reset", _STEP_RESET_ARGS))
# bools, nums, strs, pdict, odict, present, regs, scal, B, req, n_req, rollouts,
# horizon, mode, team_slot, team_codes, n_codes, totals
_SEARCH_ARGS = [_P] * 8 + [_I64, _P, _I64, _I, _I, _I, _I, _P, _I, _P]
# bools, nums, strs, pdict, odict, present, regs, scal, B, rollouts, horizon, mode,
# team_slot, team_codes, n_codes, salt, C, actions
_DECIDE_ARGS = [_P] * 8 + [_I64, _I, _I, _I, _I, _P, _I, ctypes.c_uint32, _I, _P]
# meta, prm, weights
_LG_PACK_ARGS = [_P, _P, _P]
# meta, obs, nrows, prm, weights, scratch, chunk, logits, value
_LG_FWD_ARGS = [_P, _P, _I64, _P, _P, _P, _I64, _P, _P]
# meta, obs, nrows, rowin, prm, weights, scratch, chunk, nsplit, out
_LG_GRAD_ARGS = [_P, _P, _I64, _P, _P, _P, _P, _I64, _I, _P]
# meta, obs, nrows, rowin, clip_eps, ent_coef, prm, weights, scratch, chunk, nsplit, out
_LG_ARGS = [_P, _P, _I64, _P, _F, _F, _P, _P, _P, _I64, _I, _P]
# wb, wf, dims, io, kv, u, inv_temp, top_p, max_new, logits, n_ctx
_CD_ARGS = [_P, _P, _P, _P, _P, _P, _F, _F, _I, _P, _I]
# wb, wf, dims, io, kv, rows, n_rows, scratch
_CD_PREFILL_ARGS = [_P, _P, _P, _P, _P, _P, _I, _P]
# OB: state, obs, legal, actor, B, masked; rewards: state, ended, reward, B
_OB_ARGS = [_P, _P, _P, _P, _I64, _I]
_OB_REWARD_ARGS = [_P, _P, _P, _I64]
# SA: logits, legal, noise, actor, actions, masked, logp, rows, A, mode
_SA_ARGS = [_P] * 7 + [_I64, _I, _I]


def lib_path(src: str, stem: str, cmd_prefix: list, csrc: str | None = None) -> str:
    """BUILD_DIR/<stem>_<hash>.so, the hash taken over every source file in
    `csrc` (default: the package's csrc/), `src`'s name and the command."""
    csrc = csrc or _CSRC
    digest = hashlib.sha256(os.path.basename(src).encode())
    for name in sorted(os.listdir(csrc)):
        if name.endswith(_SOURCE_EXTS):
            digest.update(name.encode())
            with open(os.path.join(csrc, name), "rb") as f:
                digest.update(f.read())
    digest.update(" ".join(cmd_prefix).encode())
    return os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")


_BUILD_LOCK = threading.RLock()
# each library this process made ready, once: {"stem", "built" (compiled
# here, not found built), "spans" (perf_counter (start, end) of finding or
# compiling it and of loading it; builds run at once overlap), "seconds"
# (the sum of its spans)}
libs_ready: list = []


def _note(stem: str, t0: float, built: bool) -> None:
    t1 = time.perf_counter()
    rec = next((r for r in libs_ready if r["stem"] == stem), None)
    if rec is None:
        rec = {"stem": stem, "built": False, "spans": [], "seconds": 0.0}
        libs_ready.append(rec)
    rec["built"] = rec["built"] or built
    rec["spans"].append((t0, t1))
    rec["seconds"] += t1 - t0


def _compile_all(jobs: list) -> list:
    """Compile each (src, stem, cmd_prefix) not yet built, all compilers
    running at once; returns the library paths in order. One thread at a
    time: a second caller waits and then finds the libraries built."""
    with _BUILD_LOCK:
        return _compile_locked(jobs)


def _compile_locked(jobs: list) -> list:
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, running = [], []
    for src, stem, cmd_prefix in jobs:
        t0 = time.perf_counter()
        so = lib_path(src, stem, cmd_prefix)
        paths.append(so)
        if os.path.exists(so):
            _note(stem, t0, False)
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = cmd_prefix + ["-I", _CSRC, src, "-o", tmp]
        err = tempfile.TemporaryFile(mode="w+")
        running.append((stem, t0, so, tmp, cmd, err,
                        subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err, text=True)))
    failures = []
    for stem, t0, so, tmp, cmd, err, proc in running:
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = -1
        err.seek(0)
        log = err.read()
        err.close()
        if rc != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failures.append(f"kernel build failed: {' '.join(cmd)}\n{log}")
            continue
        # keep the compiler's report (nvcc: -Xptxas -v registers/spills)
        with open(so[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, so)
        _note(stem, t0, True)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def _load(job: tuple) -> ctypes.CDLL:
    """The library of one (src, stem, cmd_prefix) job, found or built, then
    loaded; both noted in libs_ready."""
    with _BUILD_LOCK:
        path = _compile_all([job])[0]
        t0 = time.perf_counter()
        lib = ctypes.CDLL(path)
        _note(job[1], t0, False)
        return lib


def _nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _nvcc_cmd() -> list:
    return [_nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


_GXX_CMD = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]


def _cuda_jobs() -> list:
    return [(os.path.join(_CSRC, "rollout.cu"), "librollout", _nvcc_cmd()),
            (os.path.join(_CSRC, "lossgrad.cu"), "liblossgrad", _nvcc_cmd()),
            (os.path.join(_CSRC, "search.cu"), "libsearch", _nvcc_cmd()),
            (os.path.join(_CSRC, "chat_decode.cu"), "libchat_decode", _nvcc_cmd()),
            (os.path.join(_CSRC, "observe.cu"), "libobserve", _nvcc_cmd())]


def build_cuda() -> list:
    """Build every CUDA library at once (one nvcc per source, in parallel);
    returns their paths. cuda_lib(), lossgrad_lib(), search_lib(),
    chat_decode_lib() and observe_lib() then load them."""
    return _compile_all(_cuda_jobs())


def _rollout_common(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ge_size.restype = None
    lib.ge_size.argtypes = [_P, _I, _I, _P]  # game on the host, game_len, threads, out
    return lib


def _rollout_lib(profile: bool) -> ctypes.CDLL:
    job = _cuda_jobs()[0]
    if profile:
        job = (job[0], "librollout_profile", job[2] + ["-DGE_PROFILE"])
    lib = _rollout_common(_load(job))
    lib.ge_plan.restype = _I
    lib.ge_plan.argtypes = [_P, _I, _I64, _I, _P]  # game on the host, game_len, B, threads, out
    lib.ge_error_string.restype = ctypes.c_char_p
    lib.ge_error_string.argtypes = [_I]
    entry = lib.ge_rollout_profile if profile else lib.ge_rollout
    entry.restype = _I
    # game on the device, game on the host, game_len, ..., threads, [prof,] stream
    entry.argtypes = [_P, _P, _I] + _ROLLOUT_ARGS + [_I] + [_P] * profile + [_P]
    lib.ge_step_plan.restype = _I
    lib.ge_step_plan.argtypes = [_P, _I, _I64, _I, _P]  # game on the host, game_len, B, threads, out
    for name, args in _ST_ENTRIES:
        fn = getattr(lib, name)
        fn.restype = _I
        # game on the device, game on the host, game_len, ..., G, threads, smem, stream
        fn.argtypes = [_P, _P, _I] + args + [_I, _I, _I64, _P]
    if profile:
        lib.ge_step_sections.restype = None
        lib.ge_step_sections.argtypes = [_P]  # prof on the device, or null
    return lib


@functools.lru_cache(maxsize=None)
def cuda_lib() -> ctypes.CDLL:
    """csrc/rollout.cu built with nvcc for sm_90a, loaded: the library the
    engine runs."""
    return _rollout_lib(False)


@functools.lru_cache(maxsize=None)
def profile_lib() -> ctypes.CDLL:
    """csrc/rollout.cu built with -DGE_PROFILE: its entry ge_rollout_profile
    also takes 32 int64 of clock sums on the device. A measuring tool; the
    engine runs cuda_lib()."""
    return _rollout_lib(True)


def _host_rollout_lib(stem: str, flags: list) -> ctypes.CDLL:
    lib = _rollout_common(_load((
        os.path.join(_CSRC, "rollout_host.cpp"), stem, _GXX_CMD + flags)))
    lib.ge_rollout_host.restype = _I
    lib.ge_rollout_host.argtypes = [_P, _I] + _ROLLOUT_ARGS  # game, game_len, ...
    for name, args in _ST_ENTRIES:
        fn = getattr(lib, name + "_host")
        fn.restype = _I
        fn.argtypes = [_P, _I] + args + [_I]  # game, game_len, ..., rooms a block
    return lib


@functools.lru_cache(maxsize=None)
def host_lib() -> ctypes.CDLL:
    """csrc/rollout_host.cpp (the kernel's per-room body) built with g++."""
    return _host_rollout_lib("librollout_host", [])


@functools.lru_cache(maxsize=None)
def host_count_lib() -> ctypes.CDLL:
    """csrc/rollout_host.cpp built with -DGE_COUNT: the same body counting
    the interpreter's operations (ge_counts_reset, ge_counts_read into 4
    int64). A measuring tool; the tests run host_lib()."""
    lib = _host_rollout_lib("librollout_count", ["-DGE_COUNT"])
    lib.ge_counts_reset.restype = None
    lib.ge_counts_reset.argtypes = []
    lib.ge_counts_read.restype = None
    lib.ge_counts_read.argtypes = [_P]
    return lib


def _lossgrad_common(lib: ctypes.CDLL, suffix: str, tail: list) -> ctypes.CDLL:
    """The entries of the pipeline library: lg_pack, lg_forward (K2), lg_grad
    (K3) and lg_lossgrad (K4), named with `suffix` and taking `tail` last."""
    lib.lg_scratch_bytes.restype = _I64
    lib.lg_scratch_bytes.argtypes = [_P, _I64, _I, _I]  # meta, chunk, nsplit, fwd_only
    lib.lg_weights_bytes.restype = _I64
    lib.lg_weights_bytes.argtypes = [_P]
    lib.lg_meta_ints.restype = _I
    lib.lg_meta_ints.argtypes = []
    for name, args in (("lg_pack", _LG_PACK_ARGS), ("lg_forward", _LG_FWD_ARGS),
                       ("lg_grad", _LG_GRAD_ARGS), ("lg_lossgrad", _LG_ARGS)):
        fn = getattr(lib, name + suffix)
        fn.restype = _I
        fn.argtypes = args + tail
    return lib


@functools.lru_cache(maxsize=None)
def lossgrad_lib() -> ctypes.CDLL:
    """csrc/lossgrad.cu (the tensor-core pipelines of K2, K3 and K4) built
    with nvcc for sm_90a, loaded."""
    lib = _lossgrad_common(_load(_cuda_jobs()[1]), "", [_P])  # stream
    lib.lg_error_string.restype = ctypes.c_char_p
    lib.lg_error_string.argtypes = [_I]
    return lib


@functools.lru_cache(maxsize=None)
def lossgrad_host_lib() -> ctypes.CDLL:
    """csrc/lossgrad_host.cpp (the pipelines with plain-loop products)
    built with g++."""
    return _lossgrad_common(_load((os.path.join(_CSRC, "lossgrad_host.cpp"),
                                   "liblossgrad_host", _GXX_CMD)), "_host", [])


def _search_cuda(profile: bool) -> ctypes.CDLL:
    job = _cuda_jobs()[2]
    if profile:
        job = (job[0], "libsearch_profile", job[2] + ["-DGE_PROFILE"])
    lib = _rollout_common(_load(job))
    # game on the host, len, N, threads, out
    lib.ge_search_plan.restype = _I
    lib.ge_search_plan.argtypes = [_P, _I, _I64, _I, _P]
    lib.ge_decide_scratch.restype = _I64
    lib.ge_decide_scratch.argtypes = [_I64, _I, _I]  # B, P, C
    lib.ge_error_string.restype = ctypes.c_char_p
    lib.ge_error_string.argtypes = [_I]
    # game on the device, game on the host, game_len, ..., counter or scratch, threads,
    # [lanes,] prof, stream
    lib.ge_search.restype = _I
    lib.ge_search.argtypes = [_P, _P, _I] + _SEARCH_ARGS + [_P, _I, _P, _P]
    lib.ge_search_decide.restype = _I
    lib.ge_search_decide.argtypes = [_P, _P, _I] + _DECIDE_ARGS + [_P, _I, _I, _P, _P]
    return lib


@functools.lru_cache(maxsize=None)
def search_lib() -> ctypes.CDLL:
    """csrc/search.cu (the lookahead search's rollouts and decisions) built
    with nvcc for sm_90a, loaded."""
    return _search_cuda(False)


@functools.lru_cache(maxsize=None)
def search_profile_lib() -> ctypes.CDLL:
    """csrc/search.cu built with -DGE_PROFILE: the same entries, whose `prof`
    (5 int64 on the device) receives the groups' time in rollouts and their
    span. A measuring tool; the bots run search_lib()."""
    return _search_cuda(True)


def _host_search_lib(stem: str, flags: list) -> ctypes.CDLL:
    lib = _rollout_common(_load((
        os.path.join(_CSRC, "search_host.cpp"), stem, _GXX_CMD + flags)))
    lib.ge_search_host.restype = _I
    lib.ge_search_host.argtypes = [_P, _I] + _SEARCH_ARGS + [_P]  # game, game_len, ..., steps
    lib.ge_search_decide_host.restype = _I
    # game, game_len, ..., totals, stats, counts, shuffle
    lib.ge_search_decide_host.argtypes = [_P, _I] + _DECIDE_ARGS + [_P, _P, _P, ctypes.c_uint32]
    return lib


@functools.lru_cache(maxsize=None)
def search_host_lib() -> ctypes.CDLL:
    """csrc/search_host.cpp (the search kernel's per-rollout body) built with
    g++."""
    return _host_search_lib("libsearch_host", [])


@functools.lru_cache(maxsize=None)
def search_count_lib() -> ctypes.CDLL:
    """csrc/search_host.cpp built with -DGE_COUNT: the same body counting the
    interpreter's operations. A measuring tool; the tests run
    search_host_lib()."""
    lib = _host_search_lib("libsearch_count", ["-DGE_COUNT"])
    lib.ge_counts_reset.restype = None
    lib.ge_counts_reset.argtypes = []
    lib.ge_counts_read.restype = None
    lib.ge_counts_read.argtypes = [_P]
    return lib


def _chat_decode_common(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.cd_sizes.restype = _I
    lib.cd_sizes.argtypes = [_P, _I64, _P]  # dims, shared bytes a block, out
    return lib


def _chat_decode_cuda(profile: bool) -> ctypes.CDLL:
    job = _cuda_jobs()[3]
    if profile:
        job = (job[0], "libchat_decode_profile", job[2] + ["-DCD_PROFILE"])
    lib = _chat_decode_common(_load(job))
    if profile:
        lib.cd_profile_read.restype = _I
        lib.cd_profile_read.argtypes = [_P, _I]  # out, reset
    lib.cd_error_string.restype = ctypes.c_char_p
    lib.cd_error_string.argtypes = [_I]
    lib.cd_prefill.restype = _I
    lib.cd_prefill.argtypes = _CD_PREFILL_ARGS + [_P, _P]  # launches, stream
    lib.cd_decode.restype = _I
    lib.cd_decode.argtypes = _CD_ARGS + [_P, _P]  # launches, stream
    lib.cd_cluster_plan.restype = _I
    lib.cd_cluster_plan.argtypes = [_P, _P]  # dims, out
    return lib


@functools.lru_cache(maxsize=None)
def chat_decode_lib() -> ctypes.CDLL:
    """csrc/chat_decode.cu (the chat LM's decode: the tensor-core prefill
    and the cluster decode) built with nvcc for sm_90a, loaded."""
    return _chat_decode_cuda(False)


@functools.lru_cache(maxsize=None)
def chat_decode_profile_lib() -> ctypes.CDLL:
    """csrc/chat_decode.cu built with -DCD_PROFILE: the decode also sums
    its stages' clock cycles (cd_profile_read). A measuring tool; the
    decode runs chat_decode_lib()."""
    return _chat_decode_cuda(True)


@functools.lru_cache(maxsize=None)
def chat_decode_host_lib() -> ctypes.CDLL:
    """csrc/chat_decode_host.cpp (the decode programs' twin) built with g++."""
    lib = _chat_decode_common(_load((
        os.path.join(_CSRC, "chat_decode_host.cpp"), "libchat_decode_host", _GXX_CMD)))
    lib.cd_decode_host.restype = _I
    lib.cd_decode_host.argtypes = _CD_ARGS + [_P, _I, _P]  # rows, n_rows, scratch
    return lib


def _observe_cuda(profile: bool) -> ctypes.CDLL:
    job = _cuda_jobs()[4]
    if profile:
        job = (job[0], "libobserve_profile", job[2] + ["-DGE_PROFILE"])
    lib = _load(job)
    if profile:
        lib.ob_observe_sections.restype = None
        lib.ob_observe_sections.argtypes = [_P]  # prof on the device, or null
    lib.ob_error_string.restype = ctypes.c_char_p
    lib.ob_error_string.argtypes = [_I]
    lib.ob_plan.restype = _I
    lib.ob_plan.argtypes = [_P, _P, _I, _I64, _P]  # game, table on the host, len, B, out
    lib.ob_observe.restype = _I
    # game on the device and the host, table on the device and the host, len, ..., R, smem,
    # stream
    lib.ob_observe.argtypes = [_P, _P, _P, _P, _I] + _OB_ARGS + [_I, _I64, _P]
    lib.ob_rewards.restype = _I
    lib.ob_rewards.argtypes = [_P, _P, _I] + _OB_REWARD_ARGS + [_P]  # table x2, len, ..., stream
    lib.ob_sample.restype = _I
    lib.ob_sample.argtypes = _SA_ARGS + [_P]  # ..., stream
    return lib


@functools.lru_cache(maxsize=None)
def observe_lib() -> ctypes.CDLL:
    """csrc/observe.cu (OB, the observation entry, and SA, the sampling
    entry) built with nvcc for sm_90a, loaded."""
    return _observe_cuda(False)


@functools.lru_cache(maxsize=None)
def observe_profile_lib() -> ctypes.CDLL:
    """csrc/observe.cu built with -DGE_PROFILE: OB's launches also sum
    their block sections' clock cycles (ob_observe_sections). A measuring
    tool; the paths run observe_lib()."""
    return _observe_cuda(True)


@functools.lru_cache(maxsize=None)
def observe_host_lib() -> ctypes.CDLL:
    """csrc/observe_host.cpp (OB's and SA's bodies) built with g++."""
    lib = _load((os.path.join(_CSRC, "observe_host.cpp"), "libobserve_host", _GXX_CMD))
    lib.ob_observe_host.restype = _I
    lib.ob_observe_host.argtypes = [_P, _P, _I] + _OB_ARGS + [_I]  # game, table, len, ..., R
    lib.ob_rewards_host.restype = _I
    lib.ob_rewards_host.argtypes = [_P, _I] + _OB_REWARD_ARGS  # table, len, ...
    lib.ob_sample_host.restype = _I
    lib.ob_sample_host.argtypes = _SA_ARGS
    return lib


GAMESIM_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]


@functools.lru_cache(maxsize=None)
def gamesim_lib() -> ctypes.CDLL:
    """csrc/gamesim.cpp (the native per-room simulator, a copy of the JAX
    package's) built with g++ -O3 and loaded, its entries typed; raises with
    the compiler's output when the build fails."""
    lib = _load((os.path.join(_CSRC, "gamesim.cpp"), "libgamesim", GAMESIM_CMD))
    lib.gs_create.restype = _P
    lib.gs_create.argtypes = [_P, _I64]
    lib.gs_destroy.argtypes = [_P]
    lib.gs_room_new.restype = _P
    lib.gs_room_new.argtypes = [_P, _I, ctypes.c_uint32]
    lib.gs_room_destroy.argtypes = [_P]
    lib.gs_room_step.argtypes = [_P, _P]
    lib.gs_room_policy.argtypes = [_P, _P]
    lib.gs_state_size.restype = _I64
    lib.gs_state_size.argtypes = [_P]
    lib.gs_room_read.argtypes = [_P, _P]
    lib.gs_room_write.argtypes = [_P, _P]
    lib.gs_selfplay.restype = _I64
    lib.gs_selfplay.argtypes = [_P, _I, _I, ctypes.c_uint32, _I]
    # room, pid, rollouts, max_steps, mode, team_slot, team_codes, n_codes, salt
    search = [_P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
              ctypes.c_int32, _P, ctypes.c_int32, ctypes.c_uint32]
    lib.gs_room_search.restype = ctypes.c_int32
    lib.gs_room_search.argtypes = search
    lib.gs_room_search_scores.restype = ctypes.c_int32
    # ..., out_cands, out_scores, cap
    lib.gs_room_search_scores.argtypes = search + [_P, _P, ctypes.c_int32]
    return lib


def build_log(lib: ctypes.CDLL) -> str:
    """The compiler's report saved beside a library built here."""
    with open(lib._name[:-3] + ".log") as f:
        return f.read()
