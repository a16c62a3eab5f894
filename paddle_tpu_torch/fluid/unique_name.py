"""Unique name generator (cf. python/paddle/fluid/unique_name.py)."""

import contextlib


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = {}

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        n = self.ids[key]
        self.ids[key] += 1
        return self.prefix + key + "_" + str(n)


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


@contextlib.contextmanager
def guard(new_prefix=""):
    """Fresh name space (used by tests and program cloning)."""
    global generator
    old = generator
    generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        generator = old


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old
