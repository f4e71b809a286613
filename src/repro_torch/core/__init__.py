"""Core: the paper's contribution — OLAP Intent Signatures, canonicalization,
validation, the semantic cache with correctness-preserving derivations, and
the layered NL safety policy."""

from .cache import CacheStats, LookupResult, SemanticCache
from .middleware import Backend, Response, SemanticCacheMiddleware
from .nl_canon import MemoizedNL, NLResult, NLVocab, MeasureSense, SimulatedLLM
from .refresh import merge_tables, refreshable
from .safety import SafetyPolicy, gate_nl
from .schema import Column, Dimension, FactTable, Hierarchy, StarSchema
from .signature import (
    Filter,
    HavingClause,
    Measure,
    OrderKey,
    Signature,
    TimeWindow,
    signature_from_json,
)
from .sql_canon import CanonicalizationError, SQLCanonicalizer
from .sqlparse import SQLSyntaxError, UnsupportedQuery
from .table import ResultTable
from .validator import SignatureValidator

__all__ = [
    "Backend", "CacheStats", "CanonicalizationError", "Column", "Dimension",
    "FactTable", "Filter", "HavingClause", "Hierarchy", "LookupResult",
    "MeasureSense", "Measure", "MemoizedNL", "NLResult", "NLVocab", "OrderKey",
    "Response", "ResultTable", "SQLCanonicalizer", "SQLSyntaxError",
    "SafetyPolicy", "SemanticCache", "SemanticCacheMiddleware", "Signature",
    "SignatureValidator", "SimulatedLLM", "StarSchema", "TimeWindow",
    "UnsupportedQuery", "gate_nl", "merge_tables", "refreshable",
    "signature_from_json",
]
