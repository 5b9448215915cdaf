"""TCPStore — port of ``paddle_tpu/distributed/tcp_store.py``.

The key-value rendezvous of ``paddle.distributed.TCPStore``: the master
process hosts the table, every process (the master too) talks to it over
a client socket. The server and client are the reference's own C++
source, ``native/tcp_store.cpp``, bound through ctypes as the reference
binds it (:26-95); here it is compiled with ``g++ -O2 -shared`` at first
use into this package's ``_build`` directory (ignored by git, named by
the source's hash), never into ``native/build/``. A failed build raises.

:func:`job_store` is the job's store: ``distributed.init_parallel_env``
starts it on rank 0 of a world of more than one process and hands its
address to every rank through the process group, so the object
collectives (``all_gather_object``, ``broadcast_object_list``,
``scatter_object_list``) and :func:`barrier_via_store` need no launcher.
Under the launcher (``distributed.launch``) the store is the launcher's,
and every rank joins it as a client (``env.init_parallel_env``). A
barrier's keys are namespaced by the attempt (``env.job_namespace``: the
restart epoch and the resize generation), so a relaunched attempt never
passes a dead attempt's barrier (reference :249-260).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import threading
import time
from typing import Optional

__all__ = ["TCPStore", "barrier_via_store", "job_store", "free_port"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native",
                       "tcp_store.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_lib_lock = threading.Lock()
_lib = None


def library_path() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libtcp_store-{digest}.so")


def _build(so: str):
    """Compile the store once across processes (parallel ranks take a
    file lock and re-check under it)."""
    import fcntl
    import subprocess
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):
                return
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                 "-pthread", _SOURCE, "-o", tmp],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build the TCPStore "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SOURCE):
            raise RuntimeError(f"the TCPStore's source {_SOURCE} is missing")
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.tcp_store_server_start.restype = ctypes.c_void_p
        lib.tcp_store_server_start.argtypes = [
            ctypes.c_uint16, ctypes.POINTER(ctypes.c_uint16)]
        lib.tcp_store_server_stop.argtypes = [ctypes.c_void_p]
        lib.tcp_store_connect.restype = ctypes.c_int
        lib.tcp_store_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
        lib.tcp_store_close.argtypes = [ctypes.c_int]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64, i32, cp, u32 = (ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
                             ctypes.c_uint32)
        for name, args in (
                ("tcp_store_set", [i32, cp, u32, cp, u32]),
                ("tcp_store_get", [i32, cp, u32, cp, u32, u32p]),
                ("tcp_store_add", [i32, cp, u32, i64]),
                ("tcp_store_wait", [i32, cp, u32, i64, cp, u32, u32p]),
                ("tcp_store_delete", [i32, cp, u32]),
                ("tcp_store_delete_prefix", [i32, cp, u32]),
                ("tcp_store_ping", [i32])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = i64, args
        _lib = lib
        return lib


class TCPStore:
    """``paddle.distributed.TCPStore``: ``is_master=True`` binds the
    server (``port=0`` picks a free one, read back from ``.port``).
    Thread-safe: each Python thread gets its own connection, as in the
    reference (a shared socket would interleave requests, and a blocking
    ``wait`` would starve other threads)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 300.0):
        lib = _load_lib()
        self._lib = lib
        self._server = None
        self.host = host
        self.world_size = world_size
        self._local = threading.local()
        self._fds_lock = threading.Lock()
        self._fds: dict = {}  # thread ident -> fd
        if is_master:
            out_port = ctypes.c_uint16(0)
            self._server = lib.tcp_store_server_start(
                ctypes.c_uint16(port), ctypes.byref(out_port))
            if not self._server:
                raise RuntimeError(f"failed to bind TCPStore on port {port}")
            port = out_port.value
        self.port = port
        deadline = time.monotonic() + timeout
        while True:
            try:
                fd = self._connect()
                break
            except ConnectionError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"could not reach TCPStore at {host}:{port}")
                time.sleep(0.05)
        if lib.tcp_store_ping(fd) != 0:
            raise RuntimeError("TCPStore ping failed")

    def _connect(self) -> int:
        # the native client takes numeric IPv4 only: resolve names here
        try:
            ip = socket.gethostbyname(self.host)
        except OSError:
            ip = self.host
        fd = self._lib.tcp_store_connect(ip.encode(),
                                         ctypes.c_uint16(self.port))
        if fd < 0:
            raise ConnectionError(
                f"could not reach TCPStore at {self.host}:{self.port}")
        self._local.fd = fd
        with self._fds_lock:
            # close the connections of threads that have exited
            live = {t.ident for t in threading.enumerate()}
            for ident in [i for i in self._fds if i not in live]:
                self._lib.tcp_store_close(self._fds.pop(ident))
            prev = self._fds.get(threading.get_ident())
            if prev is not None:
                self._lib.tcp_store_close(prev)
            self._fds[threading.get_ident()] = fd
        return fd

    @property
    def _fd(self) -> int:
        fd = getattr(self._local, "fd", None)
        return self._connect() if fd is None else fd

    # -- the key-value API ----------------------------------------------------
    def set(self, key: str, value) -> None:
        v = value if isinstance(value, bytes) else str(value).encode()
        k = key.encode()
        if self._lib.tcp_store_set(self._fd, k, len(k), v, len(v)) != 0:
            raise RuntimeError("TCPStore set failed")

    def get(self, key: str) -> Optional[bytes]:
        k = key.encode()
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = ctypes.c_uint32(0)
            status = self._lib.tcp_store_get(self._fd, k, len(k), buf, cap,
                                             ctypes.byref(n))
            if status == -1:
                return None
            if status < -1:
                raise RuntimeError("TCPStore get failed")
            if n.value <= cap:
                return buf.raw[: n.value]
            cap = n.value  # larger than the buffer: fetch it whole

    def add(self, key: str, amount: int = 1) -> int:
        k = key.encode()
        res = self._lib.tcp_store_add(self._fd, k, len(k), int(amount))
        if res <= -1000:
            raise RuntimeError("TCPStore add failed")
        return int(res)

    def wait(self, key: str, timeout: Optional[float] = None) -> bytes:
        """Block until ``key`` exists and return its value;
        ``TimeoutError`` after ``timeout`` seconds (None: forever)."""
        k = key.encode()
        deadline = None if timeout is None else time.monotonic() + timeout
        cap = 1 << 16
        while True:
            tmo = -1 if deadline is None else \
                max(0, int((deadline - time.monotonic()) * 1000))
            buf = ctypes.create_string_buffer(cap)
            n = ctypes.c_uint32(0)
            status = self._lib.tcp_store_wait(self._fd, k, len(k), tmo, buf,
                                              cap, ctypes.byref(n))
            if status == -3:
                raise TimeoutError(
                    f"TCPStore wait('{key}') timed out after {timeout}s")
            if status != 0:
                raise RuntimeError("TCPStore wait failed")
            if n.value <= cap:
                return buf.raw[: n.value]
            big = self.get(key)  # larger than the buffer: fetch it whole
            if big is not None:
                return big

    def delete_key(self, key: str) -> bool:
        k = key.encode()
        return self._lib.tcp_store_delete(self._fd, k, len(k)) > 0

    def delete_prefix(self, prefix: str) -> int:
        """Erase every key starting with ``prefix``; returns the count."""
        k = prefix.encode()
        res = self._lib.tcp_store_delete_prefix(self._fd, k, len(k))
        if res <= -1000:
            raise RuntimeError("TCPStore delete_prefix failed")
        return int(res)

    def close(self):
        """Close every connection and stop the server (the master's)."""
        with self._fds_lock:
            for fd in self._fds.values():
                self._lib.tcp_store_close(fd)
            self._fds.clear()
        self._local = threading.local()
        if self._server:
            self._lib.tcp_store_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def barrier_via_store(store: TCPStore, name: str, world_size: int) -> None:
    """Everyone increments a counter, then waits for the last arrival's
    done key, under this attempt's namespace (reference :249-260)."""
    from .env import job_namespace
    key = f"__barrier/{job_namespace()}/{name}"
    arrived = store.add(key, 1)
    if arrived == world_size:
        store.set(f"{key}/done", b"1")
    store.wait(f"{key}/done")


_job = {"store": None}


def job_store() -> TCPStore:
    """The job's store: the launcher's, or the one ``init_parallel_env``
    starts for a world of more than one process; raises before that."""
    if _job["store"] is None:
        raise RuntimeError(
            "no job store: call paddle.distributed.init_parallel_env() "
            "in every process of a world of more than one process first")
    return _job["store"]


def free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port on ``host`` (bind :0, read, close); the window
    between the close and the caller's bind is accepted, as in the
    reference."""
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port
