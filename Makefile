# Dev entry points (reference Makefile parity: build/test/cover/bench/lint)

PY ?= python

.PHONY: test test8 cover bench experiment lint native clean

test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

# run the suite against an 8-virtual-device CPU mesh (the routine run
# uses 2 devices for speed; this covers larger mesh shapes)
test8:
	GRAMPLE_TEST_DEVICES=8 $(PY) -m pytest tests/ -q

cover:
	$(PY) -m pytest tests/ -q --cov=grample_tpu --cov-report=term-missing || \
		$(PY) -m pytest tests/ -q  # pytest-cov optional

bench:
	$(PY) bench.py

# full-suite acceptance runs (reference script/experiment semantics);
# override SECS/MODES/NETS, e.g. make experiment SECS=300
SECS ?= 60
MODES ?= adaptive,plain
NETS ?= all
experiment:
	mkdir -p results
	$(PY) -m grample_tpu.tools.experiments --secs $(SECS) --modes $(MODES) \
		--nets $(NETS) --out results/acceptance.jsonl

lint:
	$(PY) -m compileall -q grample_tpu tests bench.py chip_smoke.py __graft_entry__.py

native:
	$(PY) -c "from grample_tpu.native import load; assert load() is not None, 'native build failed'"

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
