"""Serving-step plumbing: cache priming and paged-cache row movement."""
