# Top-level targets mirroring the reference Makefile (all/test/clean).

PY ?= python

all: native/libmodem_host.so

native/libmodem_host.so:
	$(MAKE) -C native

# Smoke test (reference Makefile:13-15): encode one frame of random
# bytes to an 8-bit 8 kHz WAV, decode it back, require byte identity.
test: all
	mkdir -p /tmp/modem_test
	head -c 5380 /dev/urandom > /tmp/modem_test/uncoded.dat
	$(PY) -m modem.cli encode /tmp/modem_test/encoded.wav \
		8000 8 1 2000 6 N0CALL /tmp/modem_test/uncoded.dat
	$(PY) -m modem.cli decode /tmp/modem_test/decoded.dat \
		/tmp/modem_test/encoded.wav
	cmp /tmp/modem_test/uncoded.dat /tmp/modem_test/decoded.dat
	@echo smoke test passed

unittest:
	$(PY) -m pytest tests/ -x -q

clean:
	$(MAKE) -C native clean
	rm -rf .jax_cache /tmp/modem_test
