"""setup_s (s, host clock): from the process's start to the window's:
the CUDA context, the values made from the seed, the program opened, the
load and its compactions, the clients, the writer's first batch and one
statement of every type (the scan cache filled)."""


def read(w):
    return w.setup_s
