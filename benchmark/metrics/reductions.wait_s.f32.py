"""reductions.wait_s.f32: reductions.wait_s (metrics/reductions.wait_s.py)
in the float32 cells, whose runs spread wider than the float64 cells'
(their host phases weigh more), so that the end-to-end metric it feeds
carries a bound of its own."""

from harness import manifest

read = manifest.reader("reductions.wait_s").read
