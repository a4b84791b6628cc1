"""Crash-isolated dispatch of the fused IPM program.

XLA:CPU's PJRT surface has SEGFAULTED intermittently on the big fused
IPM while_loop module -- observed in-suite inside
``backend_compile_and_load``, ``LoadedExecutable.serialize()`` AND
``deserialize_executable`` (cache read), i.e. on every entry point the
module crosses -- and a persistent-cache entry written on one CPU can
be poisoned for another (the AOT loader warns about SIGILL on feature
mismatches).

So the parent never touches CPU PJRT for this module at all: a
PERSISTENT worker subprocess (one per parent process, alive across
solves so its jit trace/compile caches amortize exactly like
in-process dispatch did) receives the host numpy arrays over a pipe,
runs the fused program on the CPU backend, and ships the numpy results
back.  The worker never opens an accelerator, so the card keeps one
process.  If the worker dies or wedges, the parent restarts it and
retries -- the second retry with the persistent compilation cache
DISABLED, which dodges poisoned cache entries and the serialize path
entirely at the cost of one in-worker recompile.  If that fails too,
the caller sees a ``RuntimeError`` which ``solve_cone_lp`` converts
into a "failed" result, engaging the ordinary scipy-NLP fallback chain:
an infrastructure crash can cost one recompile or one fallback, never
the user's process.

Overhead when healthy: one pickle round-trip per solve (a few MB of
f64 at large L, ~tens of ms) -- negligible next to the solve itself.
Disable with BLUEST_TPU_IPM_ISOLATE=0 to dispatch in-process (the
pre-round-3 behavior, e.g. for debugging with breakpoints).

Reference context: the reference's cvxopt runs in-process and a solver
crash kills the run (bluest sap.py:242-307); this module is part of the
failure-detection story (SURVEY 5.3) instead.
"""

from __future__ import annotations

import os
import pickle
import select
import struct
import subprocess
import sys
import threading

import numpy as np

_HDR = struct.Struct("<Q")

# Exception types from inside the worker that indicate a CODE bug rather
# than environment/infrastructure trouble: these propagate to the caller
# (matching what in-process dispatch would do) instead of engaging the
# silent NLP-fallback chain, so a real defect in the IPM path cannot hide
# behind the isolation layer.
_BUG_EXC_TYPES = frozenset({
    "TypeError", "ValueError", "AttributeError", "NameError", "KeyError",
    "IndexError", "AssertionError", "ZeroDivisionError",
})


class IPMWorkerInfraError(RuntimeError):
    """Worker crashed/wedged/could not start after all retries -- an
    infrastructure failure, not a numerical or code one.  solve_cone_lp
    converts exactly this into status="failed" (NLP fallback)."""


def _wait_fd(fd: int, events: int, timeout: float) -> None:
    """poll()-based wait (select.select raises ValueError at fd >= 1024,
    which long jobs with snapshot spools / shm segments do reach)."""
    p = select.poll()
    p.register(fd, events)
    if not p.poll(timeout * 1000.0):
        raise TimeoutError("ipm worker timed out")


def _send_fd(fd: int, obj, timeout: float = 900.0) -> None:
    """Frame + pickle ``obj`` to ``fd`` with a bounded wait per chunk.

    A blocking write would hang the parent forever if the worker wedges
    before draining stdin (the multi-MB large-L payload outgrows the
    ~64KB pipe buffer while the worker is still starting up) -- so the
    fd is non-blocking and each chunk waits for writability under the
    timeout."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    view = memoryview(_HDR.pack(len(data)) + data)
    os.set_blocking(fd, False)
    off = 0
    while off < len(view):
        _wait_fd(fd, select.POLLOUT, timeout)
        try:
            off += os.write(fd, view[off:])
        except BlockingIOError:
            continue


def _read_exact(fd: int, n: int, timeout: float) -> bytes:
    chunks = []
    got = 0
    while got < n:
        _wait_fd(fd, select.POLLIN, timeout)
        chunk = os.read(fd, n - got)
        if not chunk:
            raise EOFError("ipm worker pipe closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_fd(fd: int, timeout: float):
    n = _HDR.unpack(_read_exact(fd, _HDR.size, timeout))[0]
    return pickle.loads(_read_exact(fd, n, timeout))


class IPMWorkerClient:
    """Parent-side handle on the persistent worker (one per process).

    Thread-safe: the MOSAP prewarm daemon thread and the main thread
    funnel through one lock, exactly like the GIL serialized the old
    in-process dispatches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._proc = None
        self._no_cache = False   # sticky after a cache-free recovery

    # ------------------------------------------------------------------ #

    def _log_path(self):
        from ..config import STATE_DIR
        return os.path.join(STATE_DIR, "ipm_worker.%d.log" % os.getpid())

    def _start(self):
        env = dict(os.environ)
        env["BLUEST_TPU_IPM_ISOLATE"] = "0"      # no recursion
        env["BLUEST_TPU_IPM_PREWARM"] = "0"
        # never open the card: JAX initializes every installed plugin
        # whatever JAX_PLATFORMS says, and the CUDA plugin's version
        # check initializes the driver, which opens the card's device
        # file; hide the cards and skip that check
        env["JAX_PLATFORMS"] = "cpu"
        env["CUDA_VISIBLE_DEVICES"] = ""
        env["JAX_SKIP_CUDA_CONSTRAINTS_CHECK"] = "1"
        if self._no_cache:
            env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
        # keep worker stderr: the SIGSEGV reports and the AOT loader's
        # feature-mismatch warnings are the tell that distinguishes the
        # documented XLA:CPU crashes from a real regression
        try:
            path = self._log_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if os.path.exists(path) and os.path.getsize(path) > (1 << 20):
                os.truncate(path, 0)             # crude 1MB rotation
            errdst = open(path, "ab")
        except OSError:
            errdst = subprocess.DEVNULL
        try:
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "bluest_tpu.solvers.ipm_worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=errdst, start_new_session=True, env=env,
                cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))))
        finally:
            if errdst is not subprocess.DEVNULL:
                errdst.close()                   # the child holds its dup

    def _log_tail(self, nbytes: int = 2048) -> str:
        try:
            with open(self._log_path(), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    def _kill(self):
        if self._proc is not None:
            try:
                self._proc.kill()
                self._proc.wait(timeout=10)
            except Exception:
                pass
            for stream in (self._proc.stdin, self._proc.stdout):
                try:                   # don't leak pipe fds across restarts
                    stream.close()
                except Exception:
                    pass
            self._proc = None

    def shutdown(self):
        with self._lock:
            self._kill()

    # ------------------------------------------------------------------ #

    def run(self, payload, timeout: float | None = None):
        """One request/response round trip with restart-and-retry.

        Attempt 0: current worker (started on demand).  Attempt 1: fresh
        worker (transient crash).  Attempt 2: fresh worker with the
        persistent compilation cache disabled (dodges poisoned entries
        and the serialize path).  Then IPMWorkerInfraError (which
        solve_cone_lp converts into the NLP-fallback chain).

        In-worker Python exceptions are classified: bug-type exceptions
        (TypeError, ValueError, ...) PROPAGATE as RuntimeError -- exactly
        what in-process dispatch would do, so the isolation layer cannot
        mask a code defect behind the fallback -- while environment-type
        ones (PJRT RuntimeErrors) take the same restart-and-retry path
        as a crash."""
        if timeout is None:
            timeout = float(os.environ.get(
                "BLUEST_TPU_IPM_WORKER_TIMEOUT", "3600"))
        send_timeout = float(os.environ.get(
            "BLUEST_TPU_IPM_WORKER_SEND_TIMEOUT", "900"))
        with self._lock:
            last = None
            for attempt in range(3):
                if attempt == 2 and not self._no_cache:
                    self._no_cache = True
                    self._kill()
                if self._proc is None or self._proc.poll() is not None:
                    self._kill()
                    try:
                        self._start()
                    except OSError as exc:
                        last = exc
                        continue
                try:
                    _send_fd(self._proc.stdin.fileno(), payload,
                             timeout=send_timeout)
                    status, value = _recv_fd(
                        self._proc.stdout.fileno(), timeout)
                except (EOFError, TimeoutError, BrokenPipeError,
                        OSError, ValueError) as exc:
                    last = exc
                    self._kill()
                    continue
                if status == "ok":
                    return value
                exc_type = str(value).split(":", 1)[0]
                if exc_type in _BUG_EXC_TYPES:
                    # deterministic code bug: no retry, no fallback
                    raise RuntimeError("ipm worker error: %s" % (value,))
                last = RuntimeError(str(value))
                self._kill()                     # environment-type: retry
            raise IPMWorkerInfraError(
                "ipm worker failed after retries: %r%s" % (
                    last, ("\n--- worker stderr tail ---\n" + tail)
                    if (tail := self._log_tail()) else ""))


_CLIENT = None
_CLIENT_LOCK = threading.Lock()


def get_client() -> IPMWorkerClient:
    global _CLIENT
    with _CLIENT_LOCK:
        if _CLIENT is None:
            _CLIENT = IPMWorkerClient()
            import atexit
            atexit.register(_CLIENT.shutdown)
        return _CLIENT


# ---------------------------- worker side -------------------------------- #

def _worker_main() -> None:
    # claim the protocol fd, then route any stray prints to stderr so
    # they cannot corrupt the frame stream
    proto_fd = os.dup(1)
    os.dup2(2, 1)
    stdin_fd = 0

    # the parent sets JAX_PLATFORMS=cpu; pin it again before any backend
    # initializes, so the worker never opens an accelerator
    import bluest_tpu.config  # noqa: F401  (x64 + cache setup)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from bluest_tpu.solvers import sdp

    while True:
        try:
            req = _recv_fd(stdin_fd, timeout=86400.0)
        except (EOFError, TimeoutError):
            return
        try:
            (arrays_np, cnorm, hnorm, step_frac, tol, feastol, max_iter,
             verbose, woodbury) = req
            arrays = tuple(jnp.asarray(a) for a in arrays_np)
            out = sdp._dispatch_ipm(arrays, cnorm, hnorm, step_frac, tol,
                                    feastol, max_iter, verbose, woodbury)
            reply = ("ok", tuple(np.asarray(v) for v in out))
        except Exception as exc:  # noqa: BLE001 - shipped to the parent
            reply = ("err", "%s: %s" % (type(exc).__name__, exc))
        _send_fd(proto_fd, reply, timeout=86400.0)


if __name__ == "__main__":
    _worker_main()
