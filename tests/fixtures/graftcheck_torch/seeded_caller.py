"""graftcheck fixture: a tick caller outside the tick plane.

NOT imported by anything — parsed by tests/test_torch_analysis.py.
``Plane`` binds the tick-plane wrapper to an attribute (imported inside
the method, as the port imports torch code lazily); ``tick`` calls it
through that attribute, so ``tick`` and what it calls directly are on
the tick path.  ``Idle`` binds nothing: its host syncs are free.
"""


class Plane:
    def start(self):
        from tests.fixtures.graftcheck_torch.ops.seeded_launch import wrapper

        self._fn = wrapper

    def tick(self, rel):
        commit, _ = self._fn(rel)
        # graftcheck: allow(host-sync) — fixture: the tick's one D2H copy
        host = rel.cpu()
        return self._read(commit), host.tolist()   # VIOLATION: .tolist()

    def _read(self, commit):
        return commit.item()                        # VIOLATION: .item()


class Idle:
    def tick(self, rel):
        return rel.cpu().numpy().tolist()
