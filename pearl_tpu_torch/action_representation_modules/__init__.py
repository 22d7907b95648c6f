from pearl_tpu_torch.action_representation_modules.modules import (
    ActionRepresentationModule,
    BinaryActionRepresentation,
    IdentityActionRepresentation,
    OneHotActionRepresentation,
)

__all__ = [
    "ActionRepresentationModule",
    "BinaryActionRepresentation",
    "IdentityActionRepresentation",
    "OneHotActionRepresentation",
]
