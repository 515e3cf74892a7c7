"""setup_s: the process's start to the window's start on the host clock:
imports, the card's context, the data drawn, the catalog, the index, the
statement prepared and the warm-up (kernel builds and loads included;
the seconds spent compiling are also given apart, as the result line's
``cold_build_s``)."""


def read(ctx):
    return ctx.setup_s
