"""Weight-decay regularizers (the counterpart of
``paddle_tpu/regularizer.py``).

The optimizer applies them inside its update: ``L2Decay(c)`` adds
``c * p`` to the gradient (or decays decoupled, AdamW), ``L1Decay(c)``
adds ``c * sign(p)``.
"""

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    pass


class L2Decay(WeightDecayRegularizer):
    pass
