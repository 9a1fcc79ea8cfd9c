"""Double-buffered host->device frame streaming: the copy/compute overlap analog.

The reference overlaps `vkCmdCopyBufferToImage` of frame k+1 with the NLM
dispatch on frame k inside one command buffer, ping-ponging two textures and
two descriptor sets (src/main.cpp:889-989, 1554-1572; README.md:43-51). Here
the same overlap falls out of XLA's async dispatch: `jax.device_put` is
asynchronous, so issuing frame k+1's upload before blocking on frame k's
compute keeps the copy engine busy under the kernel.

FramePrefetcher yields device arrays while keeping `depth` uploads in flight.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import jax
import numpy as np

from ..utils.timing import TimingReport


class FramePrefetcher:
    """Iterate device-resident frames with `depth` async uploads in flight.

    loader: maps an item (e.g. file path) to a host (H, W, 4) float32 array.
    Uploads are timed into `report.transfer` when a TimingReport is given
    (upload issue + the wait that lands on first use).
    """

    def __init__(
        self,
        items: Iterable,
        loader: Callable[[object], np.ndarray],
        depth: int = 2,
        report: Optional[TimingReport] = None,
        device=None,
        native_paths: bool = False,
    ) -> None:
        self._items = list(items)
        self._loader = loader
        self._depth = max(1, depth)
        self._report = report
        self._device = device
        self._native = None
        if native_paths:
            # items are file paths: decode them on C++ worker threads ahead of
            # use (native data-loader), falling back to the Python loader.
            try:
                from ..utils.native import FrameLoader

                self._native = FrameLoader(self._items, lookahead=self._depth + 2)
            except Exception:
                self._native = None

    def _upload(self, idx: int):
        # The host's share of the loop, as a `load_frame` span in
        # jax.profiler traces: the decode, or the wait for the native loader.
        with jax.profiler.TraceAnnotation("load_frame"):
            if self._native is not None:
                host = self._native.get(idx)
            else:
                host = self._loader(self._items[idx])
        if self._report is not None:
            with self._report.transfer():
                return jax.device_put(host, self._device)
        return jax.device_put(host, self._device)

    def __iter__(self) -> Iterator:
        pending = []
        n = len(self._items)
        for i in range(min(self._depth, n)):
            pending.append(self._upload(i))
        for i in range(n):
            if i + self._depth < n:
                pending.append(self._upload(i + self._depth))
            yield pending.pop(0)

    def __len__(self) -> int:
        return len(self._items)
