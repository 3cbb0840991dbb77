"""Helpers for the tests that hold the port (jpeg_decoder_tpu_torch) against
the JAX package (jpeg_decoder_tpu): the two packages' configs, enums, error
classes and parsed structures are equal in content and distinct in identity,
so they are compared by field names, enum member names and class names."""

import dataclasses
import enum

import numpy as np


def assert_same_fields(got, want, path="value"):
    """`got` and `want` agree field for field: dataclasses by their field
    names (their classes by __name__), enum members by name and value,
    arrays bitwise with equal dtype, containers element by element."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, path
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, path
        for n in names:
            assert_same_fields(getattr(got, n), getattr(want, n), f"{path}.{n}")
    elif isinstance(want, enum.Enum):
        assert isinstance(got, enum.Enum), path
        assert (type(got).__name__, got.name, got.value) == \
            (type(want).__name__, want.name, want.value), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_fields(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_fields(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, path


def class_chain(cls):
    """The names of `cls` and its base classes, in method-resolution order."""
    return [c.__name__ for c in cls.__mro__]


def assert_same_error_class(got, want):
    """Two error classes of the two packages are counterparts: the same
    name and the same chain of base-class names."""
    assert class_chain(got) == class_chain(want)
