"""Copied from the reference package: the ``make_lock`` lock factory and its
lock-order sanitizer."""
