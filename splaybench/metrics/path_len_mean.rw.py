"""Mean path length an op over the window, from the program's answers:
``level_found`` on the plane search, the fold's ``path_len`` on the op
list."""


def read(ctx):
    return ctx["path_len_mean"]
