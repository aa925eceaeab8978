from . import dp, myers, rank, window  # noqa: F401
