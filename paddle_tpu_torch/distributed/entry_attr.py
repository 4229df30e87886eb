"""Admission rules of a sparse embedding table (the counterpart of
``paddle_tpu/distributed/entry_attr.py``): a feature id enters the table
with a probability, after a count of shows, or weighted by show and
click statistics.  Each describes itself as the reference's attribute
string (``_to_attr``)."""
from __future__ import annotations

__all__ = ["EntryAttr", "ProbabilityEntry", "CountFilterEntry",
           "ShowClickEntry"]


class EntryAttr:
    def __init__(self):
        self._name = None

    def _to_attr(self):
        raise NotImplementedError("EntryAttr is abstract")


class ProbabilityEntry(EntryAttr):
    """Admit a new id with probability ``probability`` (a float in (0,
    1))."""

    def __init__(self, probability):
        super().__init__()
        if not isinstance(probability, float):
            raise ValueError("probability must be a float in (0,1)")
        if probability <= 0 or probability >= 1:
            raise ValueError("probability must be a float in (0,1)")
        self._name = "probability_entry"
        self._probability = probability

    def _to_attr(self):
        return ":".join([self._name, str(self._probability)])


class CountFilterEntry(EntryAttr):
    """Admit an id once it has been seen ``count_filter`` times."""

    def __init__(self, count_filter):
        super().__init__()
        if not isinstance(count_filter, int):
            raise ValueError("count_filter must be a valid integer")
        if count_filter < 0:
            raise ValueError("count_filter must be a integer larger than 0")
        self._name = "count_filter_entry"
        self._count_filter = count_filter

    def _to_attr(self):
        return ":".join([self._name, str(self._count_filter)])


class ShowClickEntry(EntryAttr):
    """Weight admission by the ``show_name`` and ``click_name``
    statistics."""

    def __init__(self, show_name, click_name):
        super().__init__()
        if not isinstance(show_name, str) or not isinstance(click_name,
                                                            str):
            raise ValueError("show_name/click_name must be strings")
        self._name = "show_click_entry"
        self._show_name = show_name
        self._click_name = click_name

    def _to_attr(self):
        return ":".join([self._name, self._show_name, self._click_name])
