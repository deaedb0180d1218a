"""PyTorch/CUDA port of the R2E-VID router (the JAX package ``repro`` is the
reference it is held against).

Layout mirrors ``repro``: ``core/`` (cost model, lattice, gate, robust CCG,
router), ``kernels/<name>/{ops,ref}.py`` with hand-written CUDA C++ sources in
``kernels/csrc/``, and ``serving/`` (simulator, policy, session, the round
graphs). Entry points take an explicit ``device`` that defaults to ``"cuda"``;
without a card they raise unless the caller passes ``device="cpu"``.
"""
