"""In-place progress reporter: bar, Hz speed, param table, stamp lines.

Port of ddpo_tpu/utils/progress.py (no JAX in it; the port keeps its own
copy). Same surface as the reference's ANSI progress bar
(ddpo/utils/progress.py:7-184): ``update(description, n)``
redraws an in-place block of [bar+percent+speed] plus an ncol-column table
of the latest params; ``stamp()`` collapses the block into one permanent
summary line; ``pause``/``resume`` release and reclaim the cursor around
interleaved prints; ``append_description`` adds free-form lines to the next
stamp; ``Silent`` absorbs every call. Values below 1e-4 render in
scientific notation (losses/KL at DDPO's 1e-4 clip scale).

Redraw uses cursor-up ANSI codes only when stdout is a TTY; under pytest or
piped logs each refresh prints a plain line instead of cursor tricks.
"""

from __future__ import annotations

import sys
import time


class Progress:
    def __init__(
        self,
        total: int,
        name: str = "Progress",
        ncol: int = 3,
        max_length: int = 20,
        indent: int = 4,
        line_width: int = 100,
        speed_update_freq: int = 100,
        print_every: int = 1,
    ):
        self.total = total
        self.name = name
        self.ncol = ncol
        self.max_length = max_length
        self.indent = indent
        self.line_width = line_width
        self.speed_update_freq = max(1, speed_update_freq)
        self.print_every = max(1, print_every)

        self.count = 0
        self._bar_size = ncol * max_length
        self._lines: list[str] = []
        self._extra_lines: list[str] = []
        self._fraction = f"0 / {total}"
        self._speed_str = "0.0 Hz"
        self._drawn_lines = 0  # lines currently owned on screen
        self._start = time.time()
        self._window_start = self._start
        self._window_count = 0
        self._tty = bool(getattr(sys.stdout, "isatty", lambda: False)())

    # -- public surface (reference names) ---------------------------------

    def __call__(self, description=None, n: int = 1) -> None:
        self.update(description, n)

    def update(self, description=None, n: int = 1) -> None:
        self.count += n
        if self.count - self._window_count >= self.speed_update_freq:
            now = time.time()
            dt = now - self._window_start
            if dt > 0:
                self._speed_str = (
                    f"{(self.count - self._window_count) / dt:.1f} Hz"
                )
            self._window_start = now
            self._window_count = self.count
        if self.count % self.print_every == 0:
            self.set_description(description or {})

    def set_description(self, params=()) -> None:
        if isinstance(params, dict):
            params = sorted(params.items())
        params = list(params) + [("T", f"{time.time() - self._start:.2f} sec")]

        header = f"{self._format_bar()} | {self._instant_speed()}"
        rows = [
            " | ".join(self._format_param(k, v) for k, v in chunk)
            for chunk in _chunks(params, self.ncol)
        ]
        self._lines = rows
        self._redraw([header] + [" " * self.indent + r for r in rows])

    def append_description(self, descr: str) -> None:
        self._extra_lines.append(str(descr))

    def stamp(self) -> None:
        """Replace the live block with one permanent summary line."""
        parts = [self._fraction] + self._lines + self._extra_lines
        line = f"[ {self.name} ] " + " | ".join(p for p in parts if p)
        line += f" | {self._speed_str}"
        self._clear()
        print(line)
        self._extra_lines = []

    def pause(self) -> None:
        self._clear()

    def resume(self) -> None:
        self._drawn_lines = 0
        self._window_start = time.time()
        self._window_count = self.count

    def close(self) -> None:
        self.pause()

    # -- rendering --------------------------------------------------------

    def _instant_speed(self) -> str:
        dt = time.time() - self._window_start
        n = self.count - self._window_count
        if n > 0 and dt > 0:
            self._speed_str = f"{n / dt:.1f} Hz"
        return self._speed_str

    def _format_bar(self) -> str:
        if not self.total:
            self._fraction = str(self.count)
            return f"{self.count} iterations"
        frac = self.count / float(self.total)
        filled = int(frac * self._bar_size)
        bar = "#" * filled + " " * (self._bar_size - filled)
        self._fraction = f"{self.count} / {self.total}"
        return f"{self._fraction} [{bar}] {int(frac * 100):3d}%"

    def _format_param(self, k, v) -> str:
        if isinstance(v, float) and 0 < abs(v) < 1e-4:
            s = f"{k} : {v:.2e}"
        else:
            s = f"{k} : {v}"
        return s[: self.max_length]

    def _redraw(self, lines: list[str]) -> None:
        if not self._tty:
            # no cursor control when captured/piped: one plain line per refresh
            print(f"[ {self.name} ] " + " | ".join(lines))
            return
        self._clear()
        for line in lines:
            print(line[: self.line_width])
        self._drawn_lines = len(lines)

    def _clear(self) -> None:
        if not self._tty or self._drawn_lines == 0:
            self._drawn_lines = 0
            return
        sys.stdout.write("\033[F\033[K" * self._drawn_lines)
        sys.stdout.flush()
        self._drawn_lines = 0


def _chunks(seq, n):
    seq = list(seq)
    return [seq[i : i + n] for i in range(0, len(seq), n)] or [[]]


class Silent:
    """No-op stand-in accepting the whole Progress surface."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        pass

    def __getattr__(self, attr):
        return lambda *args, **kwargs: None
