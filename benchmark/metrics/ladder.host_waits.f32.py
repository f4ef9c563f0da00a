"""ladder.host_waits.f32: ladder.host_waits (metrics/ladder.host_waits.py) in the float32 cells, whose runs spread
wider than the float64 cells' (their host phases weigh more), so that
the end-to-end metric it feeds carries a bound of its own."""

from harness import manifest

read = manifest.reader("ladder.host_waits").read
