#!/bin/sh
# Build the native CPU solver shared library from spock_cpu.cpp.
# spock_tpu.baselines.native runs this at first use and whenever the source
# is newer than the library.  The library is never committed: it is built
# for the CPU of the host that runs it (-march=native), and renamed into
# place so concurrent builds never load a half-written file.
set -e
cd "$(dirname "$0")"
tmp="libspock_cpu.so.tmp.$$"
g++ -O3 -march=native -ffast-math -fno-finite-math-only -shared -fPIC -o "$tmp" spock_cpu.cpp
mv -f "$tmp" libspock_cpu.so
echo "built $(pwd)/libspock_cpu.so"
