"""reset_ms.train: the mean wall time (ms) of one threshold reset
(`stage2.make_threshold_reset`: a k-th value per masked matrix) in the
traced window, synchronised before and after (the `reset` spans)."""


def read(run, peaks):
    resets = run.counters.get("resets_s") or []
    return 1e3 * sum(resets) / len(resets) if resets else None
