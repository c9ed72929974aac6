"""Paged continuous-batching serving: block bookkeeping and the engine."""
