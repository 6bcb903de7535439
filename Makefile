# Convenience targets. The native C runtime builds via native/Makefile.

.PHONY: test-fast test-full bench smoke native

# Fast tier: every subsystem at toy size, minutes on CPU (docs/REGRESSION.md)
test-fast:
	python -m pytest tests/ -x -q -m "not slow"

test-full:
	python -m pytest tests/ -x -q

# Full bench (budget-capped, needs a GPU; see bench.py header)
bench:
	python bench.py

# The main path once on one GPU, against plain references
smoke:
	python chip_smoke.py

native:
	$(MAKE) -C native
