"""Writer-priority reader-writer lock.

Guards the parameter-server weight state in ``asynchronous`` mode: many
readers (weight pulls) may hold the lock concurrently XOR one writer (delta
application); waiting writers block new readers to prevent write starvation.
``hogwild`` mode deliberately bypasses this lock entirely (lock-free updates
in the HOGWILD! style), mirroring the reference's locking policy
(``elephas/utils/rwlock.py:10-67``, ``elephas/parameter/server.py:109-131``).

Copied into the port from ``elephas_tpu/utils/rwlock.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import threading


class RWLock:
    """Several readers can hold the lock simultaneously, XOR one writer.

    Write acquisitions have priority over reads to prevent writer starvation.
    """

    def __init__(self):
        self._rwlock = 0  # >0: number of readers; -1: one writer
        self._writers_waiting = 0
        self._monitor = threading.Lock()
        self._readers_ok = threading.Condition(self._monitor)
        self._writers_ok = threading.Condition(self._monitor)

    def acquire_read(self):
        """Acquire a read lock; blocks while a writer holds or awaits it."""
        with self._monitor:
            while self._rwlock < 0 or self._writers_waiting:
                self._readers_ok.wait()
            self._rwlock += 1

    def acquire_write(self):
        """Acquire the exclusive write lock."""
        with self._monitor:
            while self._rwlock != 0:
                self._writers_waiting += 1
                try:
                    self._writers_ok.wait()
                finally:
                    self._writers_waiting -= 1
            self._rwlock = -1

    def release(self):
        """Release a read or write lock."""
        with self._monitor:
            if self._rwlock < 0:
                self._rwlock = 0
            else:
                self._rwlock -= 1
            if self._writers_waiting:
                if self._rwlock == 0:
                    self._writers_ok.notify()
            else:
                self._readers_ok.notify_all()

    # Context-manager helpers -------------------------------------------------
    class _Guard:
        def __init__(self, lock, write):
            self._lock = lock
            self._write = write

        def __enter__(self):
            if self._write:
                self._lock.acquire_write()
            else:
                self._lock.acquire_read()
            return self._lock

        def __exit__(self, *exc):
            self._lock.release()
            return False

    def reading(self) -> "_Guard":
        return RWLock._Guard(self, write=False)

    def writing(self) -> "_Guard":
        return RWLock._Guard(self, write=True)
