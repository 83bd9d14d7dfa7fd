"""setup_s: process start to the window's opening: CUDA, the kernel library
(built on a checkout's first run), the pool drawn on the card, the
warm-up calls."""


def read(rec):
    return rec.setup_s
