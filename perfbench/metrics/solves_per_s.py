"""solves_per_s: problems returned SOLVED in the window over the window's seconds
(host clock; all the work and all the time of the window)."""


def read(rec):
    return rec.solved / rec.window_s
