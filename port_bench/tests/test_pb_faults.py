"""A run with its timed path broken underneath must come out not correct:
the harness's look for a card is skipped and the rest of a run is driven at
a tiny size on the CPU, once sound and once with each fault that the cell
can have.  (One-card cells have no exchange between cards to leave out.)"""

import pytest
import torch

from port_bench.tests.tiny import drive, tiny_run


def test_sound_runs_are_correct():
    for traffic, mha in (("train-b1-l8192", False),
                         ("code-saturated", False), ("code-saturated", True)):
        run = drive(tiny_run(traffic, mha=mha))
        assert run.correct, (traffic, run.checks)
        assert run.failed == 0 and run.attempted > 0


def _broken_step(kind):
    from tpu_flash_torch.apps import machine_translation as mt

    real = mt.make_train_step

    def make(model, opt, **kw):
        step = real(model, opt, **kw)

        def unchanged(state, batch, generator=None):
            snap = {n: p.detach().clone()
                    for n, p in model.named_parameters()}
            new, loss = step(state, batch, generator)
            for n, p in model.named_parameters():
                p.data.copy_(snap[n])
            return state, loss

        def half(state, batch, generator=None):
            from port_bench.reference.gpt import half_batch

            ids, labels = half_batch(batch["input_ids"], batch["labels"])
            return step(state, dict(input_ids=ids, labels=labels,
                                    label_token_weights=torch.ones(
                                        ids.shape, device=ids.device)),
                        generator)

        return dict(unchanged=unchanged, half=half)[kind]

    return make


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_a_broken_training_step_is_not_correct(kind, monkeypatch):
    import tpu_flash_torch.apps.machine_translation as mt

    monkeypatch.setattr(mt, "make_train_step", _broken_step(kind))
    run = drive(tiny_run("train-b1-l8192"))
    assert not run.correct, run.checks


@pytest.mark.parametrize("mha", [False, True])
def test_an_altered_token_is_not_correct(mha, monkeypatch):
    from tpu_flash_torch.inference.engine import DecodeEngine

    real = DecodeEngine._host_emit

    def altered(self, slot, tok, slot_len, update_last=True):
        if self.slot_uid[slot] is not None and self.slot_uid[slot] >= 0 \
                and len(self.slot_tokens[slot]) == 3:
            tok = (tok + 1) % self.model.cfg.n_vocab
        return real(self, slot, tok, slot_len, update_last)

    monkeypatch.setattr(DecodeEngine, "_host_emit", altered)
    run = drive(tiny_run("code-saturated", mha=mha))
    assert not run.correct, run.checks
