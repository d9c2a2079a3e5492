"""The native data-path engine of the port: host C++ (``csrc/engine.cc``,
a copy of ``tpubench/native/engine.cc``) built with g++ on first use
(:mod:`.build`) and bound with ctypes (:mod:`.engine`)."""
