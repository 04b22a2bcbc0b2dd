"""Selector semantics: lanes, comparators, butterflies and the FLiMS
reference merges (counterpart of ``repro.core``)."""
