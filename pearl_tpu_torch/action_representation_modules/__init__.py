from pearl_tpu_torch.action_representation_modules.modules import (
    ActionRepresentationModule,
    IdentityActionRepresentation,
    OneHotActionRepresentation,
)

__all__ = [
    "ActionRepresentationModule",
    "IdentityActionRepresentation",
    "OneHotActionRepresentation",
]
